"""The port's dry run (``launch.dryrun``, ``launch.step_stats``) on the
CPU: ``main`` writes JAX's row keys and ``benchmarks/render_roofline.py``
renders them; the trace's dot FLOPs of REDUCED steps against the JAX
package's ``hlo_parse.loop_aware_stats(...)["dot_flops"]`` for the same
config lowered on one CPU device (equal for gemma3 ``prefill_32k``,
within ``TRAIN_FLOP_GAP`` for the train steps, whose remat recompute and
loss chunks XLA may keep or drop); the byte counter, the collective
census and ``lower_owner_gnn``'s owner exchange on a meta mesh.
"""

import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import steps as j_steps
from repro.launch.hlo_parse import loop_aware_stats
from repro_torch import tree as tr
from repro_torch.configs import base
from repro_torch.core.mesh import LocalMesh
from repro_torch.analysis.collective_audit import RecordingMesh
from repro_torch.launch import dryrun, step_stats, steps
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: the train steps' dot FLOPs against JAX's (gemma3 train_4k measured
#: +2.9%, DeepFM train_batch +1.1%)
TRAIN_FLOP_GAP = 0.05
#: JAX's dry-run row keys (``repro/launch/dryrun.py``'s ``lower_cell``)
JAX_ROW_KEYS = {"arch", "shape", "mesh", "chips", "compile_s",
                "bytes_per_device", "temp_bytes", "arg_bytes", "collectives",
                "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "flops_per_chip", "hbm_bytes", "coll_bytes",
                "useful_flops_ratio"}


def test_main_writes_jaxs_rows_and_they_render(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "deepfm", "--shape", "train_batch",
                        "--mesh", "both", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["failures"] == []
    rows = data["rows"]
    assert [(r["mesh"], r["chips"]) for r in rows] == [("16x16", 256),
                                                       ("2x16x16", 512)]
    for r in rows:
        assert JAX_ROW_KEYS <= set(r)
        assert r["temp_bytes"] is None
        assert r["bytes_per_device"] >= r["arg_bytes"] > 0
        assert r["flops_per_chip"] > 0 and r["useful_flops_ratio"] > 0
    # the table's rows: the 39 M x 10 table's rows split over model
    assert rows[0]["arg_bytes"] < 39_000_000 * 10 * 4
    run = subprocess.run([sys.executable, str(ROOT / "benchmarks" /
                                              "render_roofline.py"),
                          str(out)], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 0, run.stderr
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("| deepfm")]
    assert len(lines) == 2 and "train_batch" in lines[0]


def test_main_fails_on_a_failed_cell(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "deepfm", "--shape", "no_such_shape",
                        "--out", str(out)]) == 1
    assert json.loads(out.read_text())["failures"]


def _jax_dot_flops(arch: str, shape: str) -> float:
    """``loop_aware_stats`` dot FLOPs of the REDUCED step, lowered and
    compiled for one CPU device."""
    b = j_steps.build_bundle(j_base.get_arch(arch), shape, reduced=True)
    params = jax.eval_shape(b.init_params, jax.random.PRNGKey(0))
    first = jax.eval_shape(b.make_state, params) if b.step_kind == "train" \
        else params
    compiled = jax.jit(b.fn).lower(first, b.input_specs()).compile()
    return loop_aware_stats(compiled.as_text())["dot_flops"]


def _port_dot_flops(arch: str, shape: str, device: str) -> float:
    b = steps.build_bundle(base.get_arch(arch), shape, reduced=True,
                           device=device)
    if device == "meta":
        params, batch = b.init_params(dryrun.meta_generator()), \
            b.input_specs()
    else:
        params = b.init_params(torch.Generator().manual_seed(0))
        batch = b.make_batch(0)
    first = b.make_state(params) if b.step_kind == "train" else params
    fn = b.fn
    if b.step_kind == "prefill":       # the dry run's: the plain attention
        fn = functools.partial(b.fn, use_kernel=False)
    return step_stats.trace_step(fn, (first, batch)).dot_flops


@pytest.mark.parametrize("arch,shape,gap", [
    ("gemma3_12b", "prefill_32k", 0.0),
    ("gemma3_12b", "train_4k", TRAIN_FLOP_GAP),
    ("deepfm", "train_batch", TRAIN_FLOP_GAP)])
def test_trace_flops_match_jaxs_dot_flops(arch, shape, gap):
    """The dry run's count (meta tensors) equals the CPU step's, and holds
    to JAX's ``hlo_parse`` count."""
    want = _jax_dot_flops(arch, shape)
    got = _port_dot_flops(arch, shape, "meta")
    assert got == _port_dot_flops(arch, shape, "cpu")
    print(f"{arch} {shape}: port {got:,.0f} dot FLOPs, JAX {want:,.0f} "
          f"({got / want - 1:+.2%})")
    if gap == 0.0:
        assert got == want
    else:
        assert abs(got / want - 1) <= gap


def test_byte_counter_counts_inputs_and_outputs_and_skips_views():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    tr_ = step_stats.trace_step(lambda x, y: (x @ y).t().contiguous(),
                                (a, b))
    assert tr_.dot_flops == 2 * 64 * 32 * 16
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert tr_.bytes_accessed == mm + 2 * 64 * 16 * 4     # + the copy


def test_roofline_prices_with_the_h100_peaks():
    roof = step_stats.Roofline(flops=989e12, hbm_bytes=3.35e12,
                               coll_bytes=0.9e12, chips=4, model_flops=2e15)
    assert PEAK_FLOPS_BF16 == 989e12 and HBM_BW == 3.35e12
    row = roof.row()
    assert math.isclose(row["t_compute_s"], 1.0)
    assert math.isclose(row["t_memory_s"], 1.0)
    assert math.isclose(row["t_collective_s"], 0.9e12 / NVLINK_BW)
    assert row["bottleneck"] == "collective"
    assert math.isclose(row["useful_flops_ratio"], 2e15 / (989e12 * 4))
    assert set(row) == {"t_compute_s", "t_memory_s", "t_collective_s",
                        "bottleneck", "flops_per_chip", "hbm_bytes",
                        "coll_bytes", "useful_flops_ratio"}


def test_collective_bytes_has_jaxs_keys():
    mesh = RecordingMesh(LocalMesh((2, 2), ("data", "model"), "cpu"))
    x = torch.ones(4, 8, 3)
    tr_ = step_stats.trace_step(
        lambda: (mesh.psum(x, "model"), mesh.all_to_all(x, "data"),
                 mesh.all_gather(x, ("data", "model"))), (), mesh=mesh)
    c = tr_.collectives
    assert set(c) == {"all-reduce", "all-gather", "all-to-all",
                      "reduce-scatter", "collective-permute", "count",
                      "total"}
    assert (c["all-reduce"], c["all-to-all"], c["all-gather"]) == (
        8 * 3 * 4, 8 * 3 * 4, 4 * 8 * 3 * 4)
    assert c["count"] == 3 and c["total"] == 6 * 8 * 3 * 4


def test_lower_owner_gnn_records_the_owner_exchange():
    """GraphCast's owner exchange on a meta mesh of 256 shards: one
    all-to-all of (p * r_cap, d) f32 rows a layer, run again by each
    layer's recompute in the backward, and the loss's psum."""
    _, row = dryrun.lower_owner_gnn("graphcast", "full_graph_sm",
                                    multi_pod=False)
    cfg = base.get_arch("graphcast").config
    per_layer = 256 * row["r_cap"] * cfg.d_hidden * 4
    coll = row["collectives"]
    assert coll["all-to-all"] == 2 * cfg.n_layers * per_layer
    assert coll["count"] == 2 * cfg.n_layers + 1 and coll["all-reduce"] > 0
    assert row["coll_bytes"] == coll["total"]
    assert row["arch"] == "graphcast+owner" and row["chips"] == 256
    assert row["bytes_per_device"] >= row["arg_bytes"] > 0


def test_meta_params_cost_nothing_and_match_the_tree():
    """A cell's state on the meta device has the real step's leaves."""
    b = steps.build_bundle(base.get_arch("deepfm"), "train_batch",
                           reduced=True, device="meta")
    state = b.make_state(b.init_params(dryrun.meta_generator()))
    real = steps.build_bundle(base.get_arch("deepfm"), "train_batch",
                              reduced=True, device="cpu")
    want = real.make_state(real.init_params(torch.Generator()))
    assert [(p, tuple(x.shape), x.dtype)
            for p, x in tr.leaves_with_paths(state)] == [
        (p, tuple(x.shape), x.dtype) for p, x in tr.leaves_with_paths(want)]
    assert all(x.device.type == "meta" for x in tr.leaves(state))
