"""The port's ``bfs_serve --http`` and ``bfs_client`` against each other,
in subprocesses on the CPU: the server serves a 1-D lane and a 2-D lane
(``:2x2``) at ``--devices 4``, advertises each lane's ``spec``, and the
port's client verifies both lanes bitwise (depths and parents), then
``--shutdown`` drains the server to a clean exit.  The JAX package's
client verifies the same server.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def _client(pkg: str, port: int, graph: str, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch.bfs_client", "--url",
         f"http://127.0.0.1:{port}", "--graph", graph, "--requests", "6",
         "--batch", "3", "--concurrency", "2", "--max-retries", "2",
         "--verify", *extra], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)


def test_the_port_client_verifies_the_port_server(tmp_path):
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.bfs_serve", "--device",
         "cpu", "--devices", "4", "--graph", "er=erdos_renyi:600",
         "--graph", "grid=small_world:500:2x2", "--http", "127.0.0.1:0",
         "--buckets", "1,4", "--watchdog-secs", "30", "--port-file",
         str(port_file)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.monotonic()
        while not port_file.exists() or not port_file.read_text():
            assert server.poll() is None, server.stdout.read()
            assert time.monotonic() - t0 < TIMEOUT_S
            time.sleep(0.1)
        port = int(port_file.read_text())
        jax = _client("repro", port, "grid")
        assert jax.returncode == 0, jax.stdout + jax.stderr
        assert "match the numpy reference bitwise" in jax.stdout
        got = _client("repro_torch", port, "er", "--include-parents")
        assert got.returncode == 0, got.stdout + got.stderr
        assert "verify: 6 traversals match the numpy reference bitwise" in \
            got.stdout
        got = _client("repro_torch", port, "grid", "--include-parents",
                      "--shutdown")
        assert got.returncode == 0, got.stdout + got.stderr
        assert "6/6 ok on lane 'grid'" in got.stdout
        out, _ = server.communicate(timeout=TIMEOUT_S)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    assert server.returncode == 0, out
    assert "served 18 traversals (0 rejected 429)" in out
