"""End-to-end LM training on the PyTorch port, with checkpoint and restart
— the twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300     # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --steps 8 --batch 2 --seq 16

Trains a ~10M-parameter dense f32 transformer through the port's LM
train bundle (``launch.steps._lm_bundle``) and ``Trainer`` for a few
hundred steps on synthetic tokens, checkpointing every 50 steps, then
kills and resumes to demonstrate the restart contract: the second
``Trainer`` restores the checkpoint of step ``steps // 2`` from
``--ckpt-dir`` and trains on.  ``--device`` picks where it runs (default
``cuda``; without a card, pass ``--device cpu``).  In process,
``main(argv, on_done=f)`` calls ``f(first_trainer, second_trainer,
final_state)`` before it returns.
"""

import argparse
import tempfile

from repro_torch.configs.base import ArchSpec, LMShape, TransformerConfig
from repro_torch.launch import resolve_cli_device
from repro_torch.launch.steps import _lm_bundle
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = TransformerConfig(
    name="demo-10m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
    head_dim=32, d_ff=1024, vocab=4096, dtype="float32")


def main(argv=None, on_done=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp("repro_train_lm")

    n_params = CFG.param_count()
    print(f"model: {CFG.name} params={n_params/1e6:.1f}M")
    spec = ArchSpec("demo", "lm", CFG, CFG, "example")
    shape = LMShape("train_demo", "train", args.seq, args.batch)
    # the schedule is the bundle's: the Trainer runs bundle.fn as it is
    bundle = _lm_bundle(spec, shape, CFG, dev,
                        AdamWConfig(lr=1e-3, warmup_steps=20,
                                    total_steps=args.steps), 1)

    half = args.steps // 2
    t1 = Trainer(bundle, TrainerConfig(num_steps=half, ckpt_every=50,
                                       log_every=20, ckpt_dir=args.ckpt_dir))
    t1.run()
    print(f"-- simulated preemption at step {half}; resuming --")
    t2 = Trainer(bundle, TrainerConfig(num_steps=args.steps, ckpt_every=50,
                                       log_every=20, ckpt_dir=args.ckpt_dir))
    state = t2.run(resume=True)

    losses = [(m["step"], m["loss"]) for m in t1.metrics_log + t2.metrics_log
              if "loss" in m]
    print("step,loss")
    for s, l in losses:
        print(f"{s},{l:.4f}")
    first, last = losses[0][1], losses[-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first
    if on_done is not None:
        on_done(t1, t2, state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
