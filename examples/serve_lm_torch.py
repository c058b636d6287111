"""Continuous-batching LM serving on the PyTorch port — the twin of
``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py                 # card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Serves a small f32 model with the port's ``Server`` (per-slot sequence
depths, slot recycling) over a burst of 10 requests, drawn as the JAX
example draws them, and reports throughput on the device it ran on.  The
weights come from ``tf.init_params`` on a ``torch.Generator`` seeded 0,
not from JAX's ``PRNGKey(0)``, so the tokens differ from the JAX
example's; ``tests/test_torch_examples.py`` serves JAX's weights through
both and finds the same tokens.  As in JAX's ``Server``, a prompt's last
token is fed twice.  In process, ``main(argv, on_done=f)`` calls
``f(server, done, seconds)`` before it returns.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.launch import resolve_cli_device
from repro_torch.models import transformer as tf
from repro_torch.serve.batcher import Request, Server

CFG = TransformerConfig(
    name="demo-serve", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=512, vocab=1024, dtype="float32")


def requests(n: int = 10) -> list:
    """The example's requests, drawn from ``default_rng(0)`` in the JAX
    example's order."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, CFG.vocab, rng.integers(3, 9))
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 12)))
            for i in range(n)]


def main(argv=None, on_done=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)
    params = tf.init_params(CFG, torch.Generator(device=dev).manual_seed(0))
    srv = Server(CFG, params, batch_slots=4, max_len=64)
    reqs = requests()
    for r in reqs:
        srv.submit(r)
    t0 = time.time()
    done = srv.run_until_drained()
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {where})")
    for r in done[:4]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} out={r.out}")
    assert len(done) == len(reqs)
    if on_done is not None:
        on_done(srv, done, dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
