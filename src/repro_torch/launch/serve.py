"""Serving launcher: continuous batching over a chosen LM arch — the port
of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \
        --reduced --requests 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_34b \
        --max-len 1024 --max-new-tokens 32    # on a card, all 60 layers

Draws the weights from a seeded generator on the device (``--device
cuda``, the default, needs a card: there is no CPU fallback), submits
``--requests`` six-token prompts drawn as the JAX launcher draws them,
serves them on ``serve.batcher.Server`` and prints the JAX launcher's run
line (requests, tokens, seconds, tok/s).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import resolve_cli_device
from repro_torch.models import transformer as tf
from repro_torch.serve.batcher import Request, Server


def main(argv=None, *, on_done=None) -> int:
    """Run the launcher on ``argv``; returns the exit code.

    ``on_done(server, done, seconds)`` exists for in-process checks (the
    command line has no counterpart): it is called after the requests
    drain, with the finished requests and the serving wall time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)

    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    srv = Server(cfg, params, batch_slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        srv.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
            max_new_tokens=args.max_new_tokens))
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {toks} tokens, {dt:.2f}s "
          f"({toks/max(dt,1e-9):.1f} tok/s)")
    if on_done is not None:
        on_done(srv, done, dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
