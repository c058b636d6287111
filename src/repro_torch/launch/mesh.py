"""Mesh construction — the port of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 shards, axes ``(data, model)``.  Multi-pod:
2 x 16 x 16 = 512 shards, axes ``(pod, data, model)``; the pod axis is
pure data parallelism, so the only cross-pod collective in steady state is
the gradient all-reduce.

JAX's production meshes need 256 or 512 devices.  The port's are
``LocalMesh`` shapes on ``torch.device("meta")``: they allocate nothing and
need no card, and a step run on them moves shapes only (the dry run,
``launch/dryrun.py``).  ``Axes`` and ``mesh_axes`` read any mesh of the
``MeshAxes`` interface (``LocalMesh``, ``DistMesh``, a recording wrapper).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.mesh import default_grid  # noqa: F401  (re-export)

META = torch.device("meta")


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LocalMesh(shape, axes, META)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.axis_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical axis-name bundles for a mesh (flat tuples for 1-D jobs)."""
    dp: tuple          # data-parallel axes (includes pod when present)
    model: str         # tensor/expert-parallel axis
    flat: tuple        # every axis (BFS/GNN vertex partitioning)

    @property
    def dp_size(self):
        return None  # resolved against a mesh via sizes()

    def sizes(self, mesh):
        shape = axis_sizes(mesh)
        return {"dp": math.prod(shape[a] for a in self.dp),
                "model": shape[self.model],
                "flat": math.prod(shape[a] for a in self.flat)}


def mesh_axes(mesh) -> Axes:
    names = tuple(mesh.axis_names)
    if "pod" in names:
        return Axes(dp=("pod", "data"), model="model", flat=names)
    return Axes(dp=("data",), model="model", flat=names)


def make_host_mesh(p: int = 1, name: str = "data", device=None) -> LocalMesh:
    """A small one-axis mesh of ``p`` shards (tests, examples), on the
    card unless ``device`` names another."""
    return LocalMesh((p,), (name,), resolve_device(device))


def make_grid_mesh(r: int = 2, c: int = 2, names: tuple = ("rows", "cols"),
                   device=None) -> LocalMesh:
    """``r x c`` grid for the 2-D BFS edge partition (``LocalMesh.grid``):
    shard ``(i, j)`` owns vertex chunk ``i*c + j``; the expand phase
    gathers over ``names[1]``, the fold phase merges over ``names[0]``.
    On the card unless ``device`` names another."""
    return LocalMesh.grid(r, c, resolve_device(device), names)
