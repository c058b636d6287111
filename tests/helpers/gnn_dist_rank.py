"""Rank bodies of ``tests/test_torch_gnn_dist.py`` (run by
``helpers/dist_torch.py`` on each ``gloo`` rank; torch and the port only).

``GNN_DIST_DIR`` names the directory the test wrote ``problem.pkl`` to:
the graph, features, targets, the GraphCast config's fields and the JAX
package's weights as numpy.  Each rank writes its gradients to
``grads<rank>.npz`` and returns the loss and the collective checks.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.configs import GNNConfig
from repro_torch.core.dist_mesh import DistMesh
from repro_torch.core.mesh import LocalMesh
from repro_torch.launch.steps import autograd_grads
from repro_torch.models.convert import gnn_from_jax_params
from repro_torch.models.gnn import dist_graphcast as dg


def owner_batch(prob: dict, p: int) -> dict:
    """The global owner-exchange batch of ``prob`` over ``p`` shards."""
    routing = dg.build_routing(prob["src"], prob["dst"], prob["n"], p)
    part = routing["part"]
    return {
        "node_feats": torch.from_numpy(part.pad_vertex_array(prob["feats"])),
        "edge_feats": torch.ones((p * routing["e_cap"], 4)),
        "serve_ids": torch.from_numpy(routing["serve_ids"]),
        "src_slot": torch.from_numpy(routing["src_slot"]),
        "dst_local": torch.from_numpy(routing["dst_local"]),
        "valid_nodes": torch.from_numpy(np.arange(part.n) < prob["n"]),
        "targets": torch.from_numpy(part.pad_vertex_array(prob["targets"])),
    }


def _collective_grads(mesh: DistMesh, rank: int, p: int) -> dict:
    """The differentiable all_to_all, psum and replicate of this rank
    against autograd through the ``LocalMesh`` of all p shards."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((p, p * 3, 2)))
    w = torch.from_numpy(rng.standard_normal((p, p * 3, 2)))
    c = torch.from_numpy(rng.standard_normal((p, 5)))
    local = LocalMesh.flat(p, "cpu", "p")
    out = {}

    xl = x.clone().requires_grad_()
    (gl,) = torch.autograd.grad((local.all_to_all(xl, "p") * w).sum(), xl)
    xd = x[rank:rank + 1].clone().requires_grad_()
    yd = mesh.all_to_all(xd, "p")
    (gd,) = torch.autograd.grad((yd * w[rank:rank + 1]).sum(), xd)
    out["all_to_all"] = bool(torch.equal(
        yd.detach(), local.all_to_all(x, "p")[rank:rank + 1])
        and torch.allclose(gd, gl[rank:rank + 1], rtol=1e-12, atol=0))

    sl = c.clone().requires_grad_()
    (gl,) = torch.autograd.grad(local.psum(sl, "p")[0].square().sum(), sl)
    sd = c[rank:rank + 1].clone().requires_grad_()
    yd = mesh.psum(sd, "p")
    (gd,) = torch.autograd.grad(yd[0].square().sum(), sd)
    out["psum"] = bool(torch.allclose(gd, gl[rank:rank + 1], rtol=1e-12,
                                      atol=0))

    theta = torch.linspace(-1, 1, 5, dtype=torch.float64)
    tl = theta.clone().requires_grad_()
    (gl,) = torch.autograd.grad(
        sum(((tl * c[k]).sum() ** 2) for k in range(p)), tl)
    td = theta.clone().requires_grad_()
    (rep,) = mesh.replicate([td])
    (gd,) = torch.autograd.grad(((rep * c[rank]).sum() ** 2), td)
    out["replicate"] = bool(torch.allclose(gd, gl, rtol=1e-12, atol=1e-15))
    return out


def owner_exchange():
    """GraphCast's owner-exchange loss and gradients on this rank's
    shard of a ``DistMesh`` over the whole group."""
    d = Path(os.environ["GNN_DIST_DIR"])
    prob = pickle.loads((d / "problem.pkl").read_bytes())
    rank, p = dist.get_rank(), dist.get_world_size()
    cfg = GNNConfig(**prob["cfg"])
    mesh = DistMesh.flat("cpu", name="p")
    params = gnn_from_jax_params(prob["params"], "cpu")
    loss_fn = dg.make_loss_fn(cfg, mesh, "p")
    grads, (loss, _) = autograd_grads(loss_fn)(params, owner_batch(prob, p))
    np.savez(d / f"grads{rank}.npz", *[g.numpy() for g in grads])
    return {"loss": float(loss), "n_leaves": len(grads),
            "paths": [tr.key_of(q) for q, _ in tr.leaves_with_paths(params)],
            "local_shards": list(mesh.local_shards),
            "collectives": _collective_grads(mesh, rank, p)}
