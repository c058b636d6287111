"""Run a function on N ``gloo`` ranks of ``torch.distributed``, each a
subprocess on the CPU, with a hard deadline.

    procs = start_ranks(4, "test_torch_dist_engine:_rank_cases", tmp_dir)
    results = wait_ranks(procs, timeout=120)    # one JSON value a rank

Each rank runs this file as a script: it joins the group through a file
in ``tmp_dir`` (``init_method="file://..."``: no port), with a process
group timeout under a minute, imports ``module:function`` (the tests
directory and ``src`` are on its path), calls it with no argument and
writes its JSON-able return value to ``rank<k>.json``.  ``wait_ranks``
kills every rank once the deadline passes, so a rank that diverges fails
its test instead of hanging the suite.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: the process group's timeout: a collective that waits longer raises
PG_TIMEOUT_S = 45


def start_ranks(world: int, target: str, tmp_dir, env_extra=None) -> list:
    """Start ``world`` rank processes running ``target`` (``module:fn``);
    returns their ``(Popen, out_path)``."""
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    init = tmp_dir / "pg_init"
    env = dict(os.environ, **(env_extra or {}))
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []
    for rank in range(world):
        out = tmp_dir / f"rank{rank}.json"
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(rank),
             str(world), str(init), target, str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out))
    return procs


def wait_ranks(procs, timeout: float) -> list:
    """Wait for every rank until ``timeout`` seconds pass, then kill the
    rest; raises with the ranks' output unless every rank exited 0."""
    deadline = time.monotonic() + timeout
    logs, failed = [], False
    for proc, _ in procs:
        try:
            out, _ = proc.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
            out, _ = proc.communicate()
            out = (out or "") + f"\n[killed after {timeout} s]"
        logs.append(out or "")
        failed |= proc.returncode != 0
    if failed:
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {k} (rc {p.returncode}) ---\n{log[-3000:]}"
            for k, ((p, _), log) in enumerate(zip(procs, logs))))
    return [json.loads(out.read_text()) for _, out in procs]


def _main(argv) -> int:
    rank, world, init, target, out = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=int(rank),
        world_size=int(world),
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)()
        Path(out).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
