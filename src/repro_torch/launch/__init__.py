"""Launchers: the port's user-facing entry points.

``bfs_run``, ``bfs_serve``, ``bfs_client`` and ``bfs_chaos`` mirror the
JAX package's launchers of the same names, with one ``main(argv=None) ->
int`` each.  Every launcher but the client takes ``--device {cuda,cpu}``
(default ``cuda``; without a card it raises unless ``--device cpu`` is
given) and ``--devices N``, which sizes an in-process ``LocalMesh`` of N
shards on that device.  ``bfs_run --dist`` instead runs one shard a
process under ``torch.distributed.run`` on a ``DistMesh``
(``init_distributed`` joins the group), the counterpart of JAX's
``bfs_run --devices N`` over N devices.

This package ``__init__`` stays import-light (stdlib only), so the client
imports without torch.  JAX's ``host_devices`` and
``host_devices_from_argv`` set XLA's host device count before JAX starts;
the port has no such step (a ``LocalMesh`` is sized when it is made), so
they are not ported.
"""

from __future__ import annotations

#: what ``torch.distributed.run`` sets for every process it starts
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
#: a ``--dist`` collective that waits longer raises (a diverged rank)
PG_TIMEOUT_S = 50


def parse_graph_spec(spec: str, default_n: int):
    """Parse a launcher ``--graph`` spec: ``[name=]kind[:n][:RxC]``.

    Returns ``(name, kind, n, grid-or-None)``.  One grammar for every
    launcher (``bfs_serve`` serves the grid token as a 2-D lane;
    ``bfs_run`` rejects it in favor of its global ``--partition/--grid``
    flags) — a spec copied between their command lines either works or
    fails with a clear message, never a raw ``int()`` traceback.
    """
    name, _, rest = spec.partition("=") if "=" in spec else ("", "", spec)
    parts = rest.split(":")
    kind = parts[0]
    n, grid = default_n, None
    for tok in parts[1:]:
        if "x" in tok.lower():
            try:
                r, c = (int(x) for x in tok.lower().split("x"))
            except ValueError:
                raise SystemExit(f"bad grid token {tok!r} in --graph "
                                 f"{spec!r}; expected RxC, e.g. 2x2")
            grid = (r, c)
        else:
            try:
                n = int(tok)
            except ValueError:
                raise SystemExit(f"bad vertex count {tok!r} in --graph "
                                 f"{spec!r}; expected [name=]kind[:n][:RxC]")
    return (name or kind), kind, n, grid


def resolve_cli_device(arg: str):
    """The ``torch.device`` of a launcher's ``--device`` (``cuda`` or
    ``cpu``).  ``cuda`` without a card raises with the way out: the port
    never falls back to the CPU on its own."""
    import torch

    if arg == "cpu":
        return torch.device("cpu")
    if arg != "cuda":
        raise SystemExit(f"--device expects cuda or cpu, got {arg!r}")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default) needs a CUDA card and "
                         "none is available; pass --device cpu to run the "
                         "port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def init_distributed(backend: str = "nccl", device: str = "cuda"):
    """Join the ``torch.distributed`` group of a process started by
    ``torch.distributed.run``: reads its environment (``DIST_ENV``),
    initializes the default group on ``backend`` (``nccl`` or ``gloo``)
    with a ``PG_TIMEOUT_S`` timeout on every collective, and picks the
    process's device: ``cuda:LOCAL_RANK`` under ``device="cuda"``, else
    the CPU.  Returns ``(rank, world_size, torch.device)``.  Without the
    environment, a card of its own (for ``cuda``) or a CUDA device (for
    ``nccl``) it raises: it never falls back to one process or to the
    CPU.
    """
    import datetime
    import os

    import torch
    import torch.distributed as dist

    missing = [k for k in DIST_ENV if k not in os.environ]
    if missing:
        raise SystemExit(f"--dist runs under torch.distributed.run, which "
                         f"sets {', '.join(missing)}; start it as python -m "
                         "torch.distributed.run --nproc-per-node N -m ...")
    if backend not in ("nccl", "gloo"):
        raise SystemExit(f"--backend expects nccl or gloo, got {backend!r}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = resolve_cli_device(device)
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise SystemExit(f"LOCAL_RANK {local} has no card of its own "
                             f"({torch.cuda.device_count()} visible)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise SystemExit("--backend nccl needs --device cuda; use "
                         "--backend gloo on the CPU")
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return rank, world, dev
