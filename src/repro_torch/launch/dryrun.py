"""Production-mesh dry run: trace every (arch x shape) cell on the
production meshes and extract its roofline terms — the port of
``repro.launch.dryrun``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_12b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json

Nothing is materialised: parameters, state and inputs are tensors on
``torch.device("meta")`` (``bundle.init_params`` on a meta generator,
``bundle.input_specs()``), the mesh is a meta ``LocalMesh`` of 256 or 512
shards (``launch.mesh.make_production_mesh``), and the step runs once on
the meta device through the plain versions (the prefill with
``use_kernel=False``: no kernel can run there), so no card is needed.  JAX lowers and compiles the step for 512 forced host
devices instead; the port has no compiler, so what JAX reads from the
compiled executable is taken as follows:

* ``arg_bytes`` — exact: each leaf of the state (train) or parameters and
  of the batch, at its per-shard shape under the specs
  (``launch.shardings``; a spec that does not fit its leaf raises, as
  JAX's placement does), summed;
* ``bytes_per_device`` — ``arg_bytes`` plus the outputs less what donation
  aliases.  An output that mirrors an argument (the train state, the
  decode cache) takes that argument's specs; every other output is split
  evenly over the chips (``out_bytes``).  The port has no compiler to plan
  temporaries, so ``temp_bytes`` is ``null`` and ``bytes_per_device``
  leaves them out;
* ``flops_per_chip`` — the trace's dot FLOPs (``launch.step_stats``)
  divided by ``chips``: a floor on GSPMD's per-device count, which
  includes replicated work; ``hbm_bytes`` likewise (an unfused upper bound
  divided by ``chips``);
* ``coll_bytes`` / ``collectives`` — what the port's step runs on the
  mesh, recorded by ``analysis.collective_audit.RecordingMesh``: the MoE
  layers' ``moe_apply_sharded`` under the sharding hints, and the owner
  exchange of ``lower_owner_gnn``.  The port has no tensor-parallel GEMM
  route, so a dense LM row records none (``mesh_route`` says which);
* ``compile_s`` — the trace's seconds (no compile happens).

Each row carries JAX's keys, so ``benchmarks/render_roofline.py`` renders
the ``--out`` JSON unchanged.  ``main`` returns 1 when a cell fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import traceback

import torch

from repro_torch import tree as tr
from repro_torch.analysis.collective_audit import RecordingMesh
from repro_torch.configs.base import ARCH_IDS, get_arch, get_shape
from repro_torch.launch import shardings as sh
from repro_torch.launch.flops_est import model_flops
from repro_torch.launch.mesh import META, make_production_mesh, mesh_axes
from repro_torch.launch.step_stats import roofline, trace_step
from repro_torch.launch.steps import build_bundle
from repro_torch.models import sharding_hints


class _MetaGenerator(torch.Generator):
    """A generator whose device is ``meta``: an init draws on it without
    computing anything (``torch.randn(..., device="meta")``)."""

    @property
    def device(self) -> torch.device:
        return META


def meta_generator() -> torch.Generator:
    return _MetaGenerator()


def _tree(params):
    """A prefill / decode bundle's ``Transformer`` as its JAX-layout
    dict; any other params tree as it is."""
    return params.tree() if hasattr(params, "tree") else params


def _spread(tree, chips: int) -> int:
    """The tensor bytes of ``tree`` split evenly over ``chips`` (rounded
    up): an output whose placement GSPMD would choose."""
    total = sum(x.numel() * x.element_size() for x in tr.leaves(tree)
                if isinstance(x, torch.Tensor))
    return -(-total // chips)


def _round(row: dict) -> dict:
    return {k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in row.items()}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_owner_gnn(arch_id: str, shape_name: str, *, multi_pod: bool,
                    donate: bool = True):
    """Owner-exchange GraphCast cell (the paper's technique on the GNN):
    the train step of ``models.gnn.dist_graphcast`` on the meta mesh,
    its owner exchange recorded.  Returns (trace, meta row)."""
    from repro_torch.launch.steps import _make_state, _train_wrap
    from repro_torch.models.gnn import dist_graphcast as dg
    from repro_torch.optim.adamw import AdamWConfig

    spec = get_arch(arch_id)
    shape = get_shape(spec, shape_name)
    cfg = spec.config
    mesh = make_production_mesh(multi_pod=multi_pod)
    ax = mesh_axes(mesh)
    p = mesh.p

    def pad(x, m=64):
        return -(-int(x) // m) * m

    e_cap = pad(shape.n_edges / p * 1.25)
    r_cap = pad(min(e_cap, e_cap / p * 1.5 + 64))
    rec = RecordingMesh(mesh)
    fn = _train_wrap(dg.make_loss_fn(cfg, rec, ax.flat), AdamWConfig(),
                     autograd=True)
    params = dg.init_params(cfg, shape.d_feat, meta_generator())
    state = _make_state(params)
    pspecs = tr.map_tree(lambda _: sh.P(), params)
    sspecs = {"params": pspecs,
              "opt": {"m": pspecs, "v": pspecs, "step": sh.P()}}
    batch = dg.routing_specs(shape.n_nodes, p, shape.d_feat, cfg, r_cap,
                             e_cap)
    bspecs = dg.routing_batch_specs(ax.flat)
    arg_bytes = (sh.shard_bytes(state, sspecs, mesh)
                 + sh.shard_bytes(batch, bspecs, mesh))
    trace = trace_step(fn, (state, batch), mesh=rec)
    new_state, metrics = trace.out
    kept = sh.shard_bytes(new_state, sspecs, mesh)
    out_bytes = kept + _spread(metrics, p)
    roof = roofline(trace, p, model_flops=0.0)
    meta = {
        "arch": f"{arch_id}+owner", "shape": shape_name,
        "mesh": _mesh_name(multi_pod), "chips": p,
        "compile_s": round(trace.seconds, 1),
        "bytes_per_device": arg_bytes + out_bytes - (kept if donate else 0),
        "temp_bytes": None, "arg_bytes": arg_bytes, "out_bytes": out_bytes,
        "r_cap": r_cap, "e_cap": e_cap,
        "collectives": {k: v for k, v in trace.collectives.items() if v},
        "mesh_route": "owner exchange: one all_to_all a layer, the loss's "
                      "psum",
        **_round(roof.row()),
    }
    return trace, meta


def _batch_specs(bundle, batch, mesh):
    if bundle.family == "lm":
        return sh.lm_batch_specs(bundle.cfg, bundle.shape, mesh)
    if bundle.family == "gnn":
        return sh.gnn_batch_specs(batch, mesh)
    return sh.recsys_batch_specs(bundle.cfg, bundle.shape, mesh)


def _param_specs(bundle, params_shape, mesh, lm_mode="tp"):
    if bundle.family == "lm":
        return sh.lm_param_specs(bundle.cfg, mesh, mode=lm_mode)
    if bundle.family == "gnn":
        return sh.gnn_param_specs(params_shape, mesh)
    return sh.recsys_param_specs(bundle.cfg, mesh)


def _mesh_route(bundle) -> str:
    cfg = bundle.cfg
    if bundle.family == "lm":
        if cfg.moe is not None and any(s.moe for s in cfg.pattern):
            return "moe_apply_sharded: experts over model, a psum a layer"
        return "none: the port has no tensor-parallel GEMM route"
    return "none: the step runs the global model"


def lower_cell(arch_id: str, shape_name, *, multi_pod: bool,
               donate: bool = True, zero1: bool = True, fsdp: bool = True,
               pad: int = 512, microbatches: int = 1, seq_shard: bool = True,
               lm_mode: str = "tp", spec=None, mesh=None):
    """Trace one cell on a production mesh; returns (trace, meta row).

    Beyond JAX's arguments: ``spec`` (an ``ArchSpec`` in place of
    ``get_arch(arch_id)``, a config cut in depth), ``shape_name`` may be a
    shape object (cut in batch), and ``mesh`` (a meta ``LocalMesh`` with
    ``data`` and ``model`` axes in place of the production one, whose row
    is then named by its shape) — the card's check of the dry run
    (``chip_smoke.py`` path 15) traces path 12's cut on one chip."""
    spec = spec or get_arch(arch_id)
    bundle = build_bundle(spec, shape_name, pad=pad,
                          microbatches=microbatches, device=META)
    name = _mesh_name(multi_pod)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        name = "x".join(map(str, mesh.shape))
    chips = mesh.p

    params = bundle.init_params(meta_generator())
    params_shape = _tree(params)
    pspecs = _param_specs(bundle, params_shape, mesh, lm_mode=lm_mode)
    batch = bundle.input_specs()
    bspecs = _batch_specs(bundle, batch, mesh)
    ax = mesh_axes(mesh)
    pure_fsdp = lm_mode == "fsdp" and bundle.family == "lm"
    if pure_fsdp and bundle.step_kind == "train":
        if bundle.shape.global_batch % mesh.p == 0:
            bspecs = {"tokens": sh.P(ax.flat, None)}

    pspecs_final = pspecs
    if bundle.step_kind == "train":
        state = bundle.make_state(params)
        if fsdp and bundle.family == "lm":
            pspecs_final = sh.fsdp_specs(
                pspecs, params_shape, mesh,
                dp_axes=ax.flat if pure_fsdp else None)
        sspecs = sh.state_specs(pspecs_final, params_shape, mesh,
                                zero1=zero1, fsdp=False)
        args, arg_trees, arg_specs = ((state, batch), (state, batch),
                                      (sspecs, bspecs))
    else:
        args, arg_trees, arg_specs = ((params, batch), (params_shape, batch),
                                      (pspecs, bspecs))
    arg_bytes = sum(sh.shard_bytes(t, s, mesh)
                    for t, s in zip(arg_trees, arg_specs))

    # the plain versions: no kernel runs on meta tensors (A4's wrapper
    # takes only CUDA tensors or the CPU's)
    fn = bundle.fn
    if bundle.step_kind == "prefill":
        fn = functools.partial(bundle.fn, use_kernel=False)
    rec = RecordingMesh(mesh)
    with sharding_hints.hints(
            rec, ax.flat if pure_fsdp else ax.dp, ax.model, ax.flat,
            seq_shard=seq_shard and not pure_fsdp,
            param_specs=pspecs_final if bundle.step_kind == "train"
            else None):
        trace = trace_step(fn, args, mesh=rec)

    # outputs: the train state and the decode cache mirror an argument
    # (donated: aliased); the rest split evenly over the chips
    out, kept, aliased = trace.out, 0, 0
    if bundle.step_kind == "train":
        kept = sh.shard_bytes(out[0], arg_specs[0], mesh)
        rest, aliased = out[1], kept if donate else 0
    elif bundle.step_kind == "decode":
        kept = sh.shard_bytes(out[1], bspecs["cache"], mesh)
        rest, aliased = out[0], kept if donate else 0
    else:
        rest = out
    out_bytes = kept + _spread(rest, chips)
    roof = roofline(trace, chips, model_flops(bundle))
    meta = {
        "arch": arch_id, "shape": bundle.shape.name,
        "mesh": name, "chips": chips,
        "compile_s": round(trace.seconds, 1),
        "bytes_per_device": arg_bytes + out_bytes - aliased,
        "temp_bytes": None,
        "arg_bytes": arg_bytes, "out_bytes": out_bytes,
        "collectives": {k: v for k, v in trace.collectives.items() if v},
        "mesh_route": _mesh_route(bundle),
        "trace_flops": trace.dot_flops,
        **_round(roof.row()),
    }
    return trace, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--lm-mode", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--gnn-exchange", default="gspmd",
                    choices=["gspmd", "owner"])
    ap.add_argument("--no-donate", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch_id in ARCH_IDS:
            for shp in get_arch(arch_id).shapes:
                cells.append((arch_id, shp.name))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("give --arch and --shape, or --all")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    rows, failures = [], []
    for arch_id, shape_name in cells:
        for mp in meshes:
            tag = f"{arch_id}/{shape_name}/{'multi' if mp else 'single'}"
            try:
                if args.gnn_exchange == "owner":
                    trace, meta = lower_owner_gnn(
                        arch_id, shape_name, multi_pod=mp,
                        donate=not args.no_donate)
                else:
                    trace, meta = lower_cell(
                        arch_id, shape_name, multi_pod=mp,
                        donate=not args.no_donate, zero1=not args.no_zero1,
                        fsdp=not args.no_fsdp,
                        microbatches=args.microbatches,
                        seq_shard=not args.no_seq_shard,
                        lm_mode=args.lm_mode)
                rows.append(meta)
                print(f"OK   {tag:60s} trace={meta['compile_s']:7.1f}s "
                      f"mem/dev={meta['bytes_per_device']/2**30:6.2f}GiB "
                      f"bottleneck={meta['bottleneck']:10s} "
                      f"t=({meta['t_compute_s']:.2e},{meta['t_memory_s']:.2e},"
                      f"{meta['t_collective_s']:.2e})s", flush=True)
                del trace
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append({"cell": tag,
                                 "error": f"{type(e).__name__}: {e}"})
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "failures": failures}, f, indent=1)
        print(f"wrote {args.out}: {len(rows)} ok, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
