"""Subprocess harness: the JAX package's expert-parallel MoE
(``repro.models.moe.moe_apply`` under ``sharding_hints.hints``) on 4
forced host devices, for ``tests/test_torch_moe.py``.

Run as: python tests/helpers/moe_sharded_jax.py OUT.pkl
Writes one pickle: for each case, the MoE config's fields, JAX's weights
and tokens (numpy) and JAX's output, ``lb_loss`` and ``dropped``; plus
``_moe_apply_local``'s on the same inputs.  Kept out of the pytest
process so the suite sees one device.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro.launch import host_devices  # noqa: E402

host_devices(4)  # must precede the jax import below

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.base import MoEConfig  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models import sharding_hints  # noqa: E402

D = 16
#: name -> (mesh shape (data, model), MoE config fields, tokens)
CASES = {
    "1x4": ((1, 4), dict(n_experts=8, top_k=2, d_ff=24, shared_experts=1),
            64),
    "1x4_drops": ((1, 4), dict(n_experts=8, top_k=2, d_ff=24,
                               capacity_factor=0.5, shared_experts=1), 64),
    "2x2": ((2, 2), dict(n_experts=8, top_k=2, d_ff=24, shared_experts=1),
            64),
    "2x2_drops": ((2, 2), dict(n_experts=8, top_k=2, d_ff=24,
                               capacity_factor=0.5), 64),
    "experts_do_not_divide": ((1, 4), dict(n_experts=6, top_k=2, d_ff=24),
                              64),
    "tokens_do_not_divide": ((2, 2), dict(n_experts=8, top_k=2, d_ff=24),
                             63),
}


def main(out_path: str) -> int:
    devs = np.asarray(jax.devices())
    assert devs.size == 4, devs
    out = {}
    for i, (name, (shape, fields, t)) in enumerate(CASES.items()):
        cfg = MoEConfig(**fields)
        params = moe.init_moe_params(jax.random.PRNGKey(i), D, cfg,
                                     jnp.float32)
        x = np.random.default_rng(i).standard_normal((t, D)).astype(
            np.float32)
        mesh = Mesh(devs.reshape(shape), ("data", "model"))
        with sharding_hints.hints(mesh, ("data",), "model"):
            y, aux = jax.jit(lambda p, a: moe.moe_apply(p, a, cfg))(
                params, jnp.asarray(x))
        y_loc, aux_loc = jax.jit(moe._moe_apply_local, static_argnums=2)(
            params, jnp.asarray(x), cfg)
        out[name] = {
            "shape": shape, "fields": fields, "x": x,
            "params": jax.tree.map(np.asarray, params),
            "out": np.asarray(y), "lb_loss": float(aux["lb_loss"]),
            "dropped": int(aux["dropped"]),
            "local_out": np.asarray(y_loc),
            "local_lb_loss": float(aux_loc["lb_loss"]),
            "local_dropped": int(aux_loc["dropped"])}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
