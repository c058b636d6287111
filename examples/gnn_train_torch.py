"""GNN training on the PyTorch port: a full-batch GCN, then GatedGCN on
sampled minibatches — the twin of ``examples/gnn_train.py``.

    PYTHONPATH=src python examples/gnn_train_torch.py                # card
    PYTHONPATH=src python examples/gnn_train_torch.py --device cpu

``full_batch`` trains ``gcn_cora``'s reduced config on ``full_graph_sm``
through the ``Trainer`` (checkpoints in a temporary directory, removed
after).  ``sampled_minibatch`` trains ``gatedgcn``'s reduced config on
subgraphs that ``NeighborSampler`` draws from an Erdős-Rényi graph, with
a plain step: ``gnn.loss_fn``, gradients by ``torch.autograd`` and
``apply_updates``; its batches and targets are the JAX example's, bit
for bit.  ``FULL`` and ``SAMPLED`` hold the run's sizes, JAX's.
``--device`` picks where it runs (default ``cuda``; without a card, pass
``--device cpu``).  In process, ``main(argv, on_done=f)`` calls
``f(full, sampled)`` with ``full_batch``'s and ``sampled_minibatch``'s
results before it returns.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import graph_minibatch_stream
from repro_torch.graphs import csr_from_coo, erdos_renyi
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.launch import resolve_cli_device
from repro_torch.launch.steps import autograd_grads, build_bundle
from repro_torch.models.gnn import models as gnn
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.train.trainer import Trainer, TrainerConfig

FULL = {"steps": 30, "ckpt_every": 10}
SAMPLED = {"n": 5_000, "avg_degree": 20, "steps": 20}


def full_batch_bundle(dev):
    return build_bundle(get_arch("gcn_cora"), "full_graph_sm", reduced=True,
                        device=dev)


def full_batch(dev) -> dict:
    """``FULL["steps"]`` Trainer steps; prints the first and last logged
    loss as the JAX example does.  Each step draws a new random graph with
    random labels, so those two readings differ mostly by the batches (the
    JAX example's assert that the last is lower holds for some seeds of
    the weights and not for others).  What training moves is the loss on
    the same data: the check is that the mean loss over the run's own
    batches falls from the initial params to the trained ones.  Returns
    the ``Trainer`` and that mean loss before and after."""
    bundle = full_batch_bundle(dev)
    # the state the Trainer would draw (TrainerConfig.seed 0); the GNN
    # update is functional, so it stays the initial state
    init = bundle.make_state(bundle.init_params(
        torch.Generator(device=dev).manual_seed(0)))
    with tempfile.TemporaryDirectory("repro_gcn") as ckpt_dir:
        t = Trainer(bundle, TrainerConfig(
            num_steps=FULL["steps"], ckpt_every=FULL["ckpt_every"],
            log_every=5, ckpt_dir=ckpt_dir))
        state = t.run(init_state=init)
    losses = [m["loss"] for m in t.metrics_log if "loss" in m]
    print(f"gcn full-batch: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    batches = [bundle.make_batch(seed=step) for step in range(FULL["steps"])]

    def mean_loss(params) -> float:
        return float(np.mean([float(gnn.loss_fn(bundle.cfg, params, b)[0])
                              for b in batches]))

    before, after = mean_loss(init["params"]), mean_loss(state["params"])
    print(f"gcn full-batch: mean loss over the run's {len(batches)} batches "
          f"{before:.5f} -> {after:.5f}")
    assert after < before
    return {"trainer": t, "mean_loss": (before, after)}


def make_train_step(cfg, ocfg: AdamWConfig):
    """``(params, opt, batch) -> (params, opt, loss)``: the loss, its
    gradients by ``torch.autograd`` (the layers run under
    ``torch.utils.checkpoint``) and a functional AdamW update."""
    grad_fn = autograd_grads(lambda p, b: gnn.loss_fn(cfg, p, b))

    def train_step(params, opt, batch):
        grads, (loss, _) = grad_fn(params, batch)
        params, opt, _ = apply_updates(ocfg, params,
                                       tr.unflatten(params, grads), opt)
        return params, opt, loss
    return train_step


def sampled_minibatch(dev, on_step=None) -> dict:
    """GatedGCN on sampled subgraphs of a reddit-like synthetic graph.
    ``on_step(i, batch, loss)`` sees each step's device batch.  Returns
    the losses, the host ms to draw each batch onto the device and each
    step's ms up to reading its loss, and ``last``: the step function
    with the final params, optimizer state and batch."""
    spec = get_arch("gatedgcn")
    cfg = spec.reduced
    # a reddit-like synthetic graph + the real neighbor sampler
    n = SAMPLED["n"]
    src, dst = erdos_renyi(n, avg_degree=SAMPLED["avg_degree"], seed=0)
    indptr, indices = csr_from_coo(src, dst, n)
    sampler = NeighborSampler(indptr, indices)
    stream = graph_minibatch_stream(sampler, batch_nodes=32, fanouts=(5, 3),
                                    n_pad=1024, e_pad=1024, d_feat=16, seed=0)
    try:
        params = gnn.init_params(cfg, 16, torch.Generator(
            device=dev).manual_seed(0))
        opt = init_state(params)
        train_step = make_train_step(cfg, AdamWConfig(lr=3e-3))
        rng = np.random.default_rng(0)
        losses, batch_ms, step_ms = [], [], []
        for i in range(SAMPLED["steps"]):
            t0 = time.perf_counter()
            _, host = next(stream)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
                     if k != "global_ids"}
            batch["targets"] = torch.from_numpy(
                rng.standard_normal((batch["node_feats"].shape[0],
                                     cfg.d_out)).astype(np.float32)).to(dev)
            t1 = time.perf_counter()
            params, opt, l = train_step(params, opt, batch)
            losses.append(float(l))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            batch_ms.append((t1 - t0) * 1e3)
            if on_step is not None:
                on_step(i, batch, losses[-1])
    finally:
        stream.close()
    print(f"gatedgcn sampled-minibatch: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} over {len(losses)} sampled subgraphs")
    return {"losses": losses, "batch_ms": batch_ms, "step_ms": step_ms,
            "last": (train_step, params, opt, batch)}


def main(argv=None, on_done=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)
    full = full_batch(dev)
    sampled = sampled_minibatch(dev)
    if on_done is not None:
        on_done(full, sampled)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
