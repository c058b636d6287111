"""``models.moe.moe_apply`` under the port's sharding hints on the CPU:
the expert-parallel route on the hinted mesh and axes, bitwise
``moe_apply_sharded`` there, and within ``test_torch_moe.py``'s f32
tolerance of the JAX package's hinted route (``helpers/moe_sharded_jax.py``
on 4 host devices, in a subprocess), its fallbacks to the local route
too; with hints unset, the local route."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.configs import MoEConfig
from repro_torch.core.mesh import LocalMesh
from repro_torch.models import moe
from repro_torch.models import sharding_hints

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# test_torch_moe.py's: f32 on both sides, sums in another order
TOL = {"atol": 1e-5, "rtol": 1e-5}


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's ``moe_apply`` under hints on 4 host devices, run once."""
    out = tmp_path_factory.mktemp("moe_hinted") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "helpers" /
                             "moe_sharded_jax.py"), str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return pickle.loads(out.read_bytes())


@pytest.mark.parametrize("name", ["1x4", "1x4_drops", "2x2", "2x2_drops",
                                  "experts_do_not_divide",
                                  "tokens_do_not_divide"])
def test_moe_apply_under_hints_takes_the_sharded_route(jax_sharded, name):
    case = jax_sharded[name]
    params = tr.map_tree(lambda a: torch.from_numpy(np.array(a)),
                         case["params"])
    x = torch.from_numpy(case["x"])
    cfg = MoEConfig(**case["fields"])
    mesh = LocalMesh(case["shape"], ("data", "model"), "cpu")
    try:
        with sharding_hints.hints(mesh, ("data",), "model"):
            got, aux = moe.moe_apply(params, x, cfg)
    finally:
        sharding_hints.clear_hints()
    want, want_aux = moe.moe_apply_sharded(params, x, cfg, mesh, ("data",),
                                           "model")
    assert torch.equal(got, want)
    assert torch.equal(aux["lb_loss"], want_aux["lb_loss"])
    assert int(aux["dropped"]) == case["dropped"]
    np.testing.assert_allclose(got.numpy(), case["out"], **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]), case["lb_loss"], **TOL)
    # hints unset: the local route
    local, _ = moe.moe_apply(params, x, cfg)
    assert torch.equal(local, moe._moe_apply_local(params, x, cfg)[0])
