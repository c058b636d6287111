"""Subprocess harness: the JAX package's ``repro.train.elastic.reshard_state``
on 4 forced host devices, for ``tests/test_torch_elastic.py``.

Run as: python tests/helpers/elastic_jax.py OUT.pkl
Places a seeded state on a (data 2, model 2) mesh of 4 devices, reshards
it onto a one-axis mesh of the first 2 devices (``ok``: the leaves as
numpy), and tries each spec of ``BAD`` (``raises``: the exception's type
name, or None); the pickle also holds the state and the specs, as tuples
of their entries.  Kept out of the pytest process so the suite sees one
device.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro.launch import host_devices  # noqa: E402

host_devices(4)  # must precede the jax import below

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.train.elastic import reshard_state  # noqa: E402

#: the test's state: name -> (shape, dtype)
LEAVES = {"w": ((8, 6), np.float32), "b": ((6,), np.float32),
          "ids": ((4, 3), np.int32), "step": ((), np.int32)}
#: (old spec, new spec) a leaf; the new mesh is ("x",) of 2 devices
GOOD = {"w": (P("data", "model"), P("x", None)), "b": (P("model"), P()),
        "ids": (P("data", None), P(None, None)), "step": (P(), P())}
#: name -> new specs of the w leaf that JAX's placement must refuse
BAD = {"indivisible": P("x", None),
       "unknown_axis": P("model", None), "repeated_axis": P("x", "x")}


def state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 100).astype(d)
            for k, (s, d) in LEAVES.items()}


def main(out_path: str) -> int:
    devs = np.asarray(jax.devices())
    assert devs.size == 4, devs
    old = Mesh(devs.reshape(2, 2), ("data", "model"))
    new = Mesh(devs[:2], ("x",))
    host = state()
    placed = {k: jax.device_put(v, NamedSharding(old, GOOD[k][0]))
              for k, v in host.items()}
    out = reshard_state(placed, new, {k: GOOD[k][1] for k in host})
    res = {"state": host,
           "new_specs": {k: tuple(GOOD[k][1]) for k in host},
           "bad_specs": {k: tuple(v) for k, v in BAD.items()},
           "ok": {k: np.asarray(v) for k, v in out.items()},
           "ok_devices": {k: sorted(d.id for d in v.devices())
                          for k, v in out.items()},
           "raises": {}}
    bad_state = {"w": jax.device_put(np.zeros((7, 6), np.float32),
                                     NamedSharding(old, P()))}
    for name, spec in BAD.items():
        src = bad_state if name == "indivisible" else {"w": placed["w"]}
        try:
            reshard_state(src, new, {"w": spec})
            res["raises"][name] = None
        except Exception as e:  # noqa: BLE001 — recorded for the test
            res["raises"][name] = type(e).__name__
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
