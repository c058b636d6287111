"""Training launcher — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
        --shape train_batch --steps 20 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_12b \
        --shape train_4k --steps 5 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gatedgcn \
        --shape minibatch_lg --steps 5 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx_132b \
        --shape train_4k --steps 5 --reduced --device cpu

Builds the cell's train bundle (``launch.steps.build_bundle``) on the
device (``--device cuda``, the default, needs a card: there is no CPU
fallback) and runs ``train.trainer.Trainer``, printing its metric log as
the JAX launcher does.  ``--compression`` sets
``TrainerConfig.grad_compression``, which the trainer does not read (as in
the JAX package; ROADMAP Queue C).
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.launch import resolve_cli_device
from repro_torch.launch.steps import build_bundle
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None, *, on_trainer=None) -> int:
    """Run the launcher on ``argv``; returns the exit code.

    ``on_trainer(trainer)`` exists for in-process checks (the command
    line has no counterpart): it is called after the run, with the
    trainer's metric log, step times and checkpoint manager."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "topk"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)

    spec = get_arch(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    bundle = build_bundle(spec, args.shape, reduced=args.reduced,
                          device=dev, opt_cfg=opt_cfg,
                          microbatches=args.microbatches)
    if bundle.step_kind != "train":
        raise SystemExit(f"{args.shape} is a {bundle.step_kind} cell; use "
                         f"launch.serve")

    tcfg = TrainerConfig(num_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         grad_compression=args.compression)
    trainer = Trainer(bundle, tcfg, opt_cfg=opt_cfg)
    trainer.run()
    for m in trainer.metrics_log:
        print(m)
    if trainer.straggler_events:
        print(f"straggler events: {trainer.straggler_events}")
    if on_trainer is not None:
        on_trainer(trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
