"""Rank body of ``tests/test_torch_moe.py`` (run by
``helpers/dist_torch.py`` on each ``gloo`` rank; torch and the port only).

``MOE_DIST_DIR`` names the directory the test wrote ``cases.pkl`` to (the
cases of ``helpers/moe_sharded_jax.py``: mesh shape, MoE fields, weights
and tokens as numpy).  Each rank runs ``moe_apply_sharded`` on a
``DistMesh`` of each case's shape, writes its output to
``<case>_rank<k>.npy`` and returns ``lb_loss``, ``dropped`` and its
``local_shards`` by case.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.configs import MoEConfig
from repro_torch.core.dist_mesh import DistMesh
from repro_torch.models import moe


def sharded_cases() -> dict:
    d = Path(os.environ["MOE_DIST_DIR"])
    cases = pickle.loads((d / "cases.pkl").read_bytes())
    rank = dist.get_rank()
    out = {}
    for name, case in cases.items():
        mesh = DistMesh(case["shape"], ("data", "model"), "cpu")
        params = tr.map_tree(lambda a: torch.from_numpy(np.array(a)),
                             case["params"])
        y, aux = moe.moe_apply_sharded(
            params, torch.from_numpy(case["x"]), MoEConfig(**case["fields"]),
            mesh, ("data",), "model")
        np.save(d / f"{name}_rank{rank}.npy", y.numpy())
        out[name] = {"lb_loss": float(aux["lb_loss"]),
                     "dropped": int(aux["dropped"]),
                     "local_shards": list(mesh.local_shards)}
    return out
