"""Checkpoint manager: atomic, versioned, resumable, keep-last-k — the port
of ``repro.train.checkpoint``, writing the same files.

Layout:  ``<dir>/step_<n>/manifest.json`` + ``leaf_%05d.npy`` a leaf.
The manifest lists each leaf's key (its path parts joined by ``/``, such
as DeepFM's ``params/mlp/0/w`` or an LM's ``params/blocks/0/attn/wq``,
in ``jax.tree``'s leaf order), file, shape and
dtype; a bf16 leaf is stored as its ``uint16`` bit pattern and tagged
``"bfloat16"``.  So either package restores the other's checkpoints.
Writes go to ``step_<n>.tmp`` and are renamed into place, so a failure
mid-save never corrupts the latest checkpoint.

``saves`` records each published save (step, bytes, seconds from the
snapshot to the rename).  The save snapshots every leaf into host memory it owns (a copy, on the
CPU too, where ``tensor.numpy()`` would share the tensor's storage and an
asynchronous write could see a later in-place update).  ``restore``
returns tensors on the device of each leaf of ``like``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import tree as tr


def _to_host(t: torch.Tensor):
    """(a host copy of ``t`` as numpy, its dtype's name in the
    manifest)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread = None
        self.saves = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state) -> str:
        self.wait()                 # one outstanding async save at a time
        t0 = time.perf_counter()
        host = [(tr.key_of(path), *_to_host(leaf))
                for path, leaf in tr.leaves_with_paths(state)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, t0), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, t0)
        return os.path.join(self.dir, f"step_{step}")

    def _write(self, step: int, host_leaves, t0: float):
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (key, arr, logical) in enumerate(host_leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape),
                 "dtype": logical})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic publish
        self.saves.append({"step": step,
                           "bytes": sum(a.nbytes for _, a, _ in host_leaves),
                           "seconds": time.perf_counter() - t0})
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None):
        """Restore into the structure of ``like`` (a tree of tensors).
        Returns (state, step): each leaf a tensor on the device of
        ``like``'s leaf, or (None, None) with no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        leaves = []
        for p, ref in tr.leaves_with_paths(like):
            key = tr.key_of(p)
            if key not in by_key:
                raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
            e = by_key[key]
            arr = np.load(os.path.join(path, e["file"]))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(ref.shape)}")
            if e["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves.append(t.to(ref.device))
        return tr.unflatten(like, leaves), step
