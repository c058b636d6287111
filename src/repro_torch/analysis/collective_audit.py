"""Plan auditor (``hlo_audit``): do the collectives a traversal makes match
the plan's accounting?  The port of ``repro.analysis.hlo_audit``.

The paper's contribution is disciplined communication — every level's
collective and its byte cost is known ahead of time — and the planner
trusts the analytic byte models of the exchange registry blindly.  The
JAX pass parses the compiled while loop's HLO; the port has no HLO, so
this pass drives one traversal of the engine's plan on a
``RecordingMesh``: a wrapper of the plan's mesh (a ``LocalMesh``, or this
rank's ``DistMesh``) that delegates each ``all_to_all`` / ``all_gather``
/ ``psum_scatter`` / ``psum`` / ``pmax`` and records its kind, axis and
group size, input and output shape and dtype, the bytes each shard
receives (converted from the output bytes as ``_recv_bytes`` says:
all-gather and all-to-all ``out*(g-1)/g``, reduce-scatter ``out*(g-1)``,
all-reduce ``out*2(g-1)/g``), the level and
its kind (the level runner announces each level, ``enter_level``), and
the registered strategy that made the call (the plan strategy's ``impl``
on the call stack).  It records shapes only: no sync and no copy.  The
census is then asserted against the plan's resolved strategies:

  * every exchange role the plan prices (dense / queue / expand / fold /
    sparse twins / sieve gather / bottom-up gather) has a collective in
    some level of its kind (HA001; a role whose level kind the traversal
    never reached is reported as ``info``), and no collective goes
    unpriced (HA002);
  * per role, the bytes a shard receives agree with the registered byte
    model within a documented tolerance (HA003), a level at a time;
  * group sizes span the mesh axis the role runs over (HA007);
  * the engine's ``(n, S)`` dist and frontier buffers are reused across
    runs, not reallocated (HA004, the counterpart of JAX's donation);
  * the traversal ran at least one level and, at p > 1, made a
    collective inside one (HA001: else the census saw nothing);
  * a level reads the device at most ``HOST_READ_BUDGET`` times, at the
    sites the lint lists (HA005: JAX checks that no host transfer hides
    in the compiled loop; the port's loop reads a flag a level by
    design).  On the CPU the recording mesh counts ``host_read``; on a
    card ``torch.cuda.set_sync_debug_mode`` counts every synchronizing
    call of the level, the hidden ones too (not over ``gloo``, a host
    transport whose every collective synchronizes: there it counts
    ``host_read`` too);
  * optionally, two traversals from distinct sources leave
    ``trace_count`` at ``compile_traces`` (HA006).

Small all-reduces (<= ``CONTROL_CUTOFF`` bytes) are a loop's control
plane and are censused but never priced: the mesh's ``psum`` and
``pmax`` of the termination flag, the level statistics and the overflow
flag and sieve hits, each reduced before its host read (HA005), as JAX's
psums.  The sieve's summary gather is priced by the ``sieve`` role, as in
JAX.
Everything lands in an ``AuditReport`` consumed by tests,
``bfs_run --audit`` and the ``bfs_audit`` gate.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import sys
import warnings
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.analysis import lint as _lint
from repro_torch.analysis.report import AuditReport
from repro_torch.core import bfs as _bfs
from repro_torch.core import engine as _engine
from repro_torch.core import exchange as ex
from repro_torch.core import frontier as fr
from repro_torch.core import dist_mesh as _dist_mesh
from repro_torch.core import mesh as _mesh

# Replicated scalar reductions (termination, overflow, mode pick) are
# control flow, not payload; a collective bigger than this many bytes must
# be priced by a byte model.
CONTROL_CUTOFF = 1024

# Documented tolerance on recorded-received vs modeled bytes per role.
# The models are exact for every wire tier, so the band mostly absorbs
# dtype widening (bf16 reduce tiers); drift beyond it means a
# mis-registered model.
DEFAULT_TOLERANCE = (0.3, 3.0)

#: device reads a level may make, by its kind; "sources" is the read of
#: the sources' statistics before the first level (queue and auto
#: modes), "escalated" a queue level that overflowed and ran dense: its
#: two reads, and on the 2-D partition a recount of the sieve's hits over
#: every active edge when a truncated compressed frontier decoded past
#: the level's width
HOST_READ_BUDGET = {"sources": 1, "dense": 1, "queue": 2, "bottom_up": 1,
                    "escalated": 3}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.dirname(_PKG_DIR)
_SKIP_FILES = (os.path.abspath(_mesh.__file__),
               os.path.abspath(_dist_mesh.__file__),
               os.path.abspath(__file__))
# a strategy kind's role, and the kind of level that calls it
_KIND_ROLE = {"dense": "dense", "queue": "queue", "expand_row": "expand",
              "fold_col": "fold", "expand_row_sparse": "expand_sparse",
              "fold_col_sparse": "fold_sparse"}
_KIND_LEVEL = {"dense": "dense", "expand_row": "dense", "fold_col": "dense",
               "queue": "queue", "expand_row_sparse": "queue",
               "fold_col_sparse": "queue"}
# where a role's collective runs: "queue_sparse" is a queue level that
# did not escalate to dense (its sparse exchange ran)
_ROLE_LEVEL = {"dense": "dense", "expand": "dense", "fold": "dense",
               "queue": "queue_sparse", "fold_sparse": "queue_sparse",
               "expand_sparse": "queue", "sieve": "queue",
               "bottom_up": "bottom_up"}


@dataclasses.dataclass
class CollectiveOp:
    """One collective a traversal made on the recording mesh."""

    kind: str                 # all-gather | all-to-all | reduce-scatter
    out_bytes: float          # output bytes a shard holds
    recv_bytes: float         # bytes received per participant (module doc)
    group_size: int           # participants of the collective's group
    n_groups: int
    in_loop: bool             # made inside a level of the level runner
    source: str               # "exchange.py:197": the call site
    level: int = 0            # 1-based level (0: outside the levels)
    level_kind: str = ""      # the kind the runner ran the level as
    strategy: str = ""        # "kind:name" of the strategy on the stack
    hint: str = ""            # the role the stack names ("" = unnamed)
    axis: str = ""
    in_shape: tuple = ()      # per shard
    out_shape: tuple = ()     # per shard
    dtype: str = ""
    role: str = ""            # census role after matching ("" = unmatched)
    model_bytes: float = 0.0  # per-instance model of the matched role

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HostRead:
    """One read of the device inside the level loop."""

    level: int
    level_kind: str           # bfs.LEVEL_KINDS, "sources", "outside"
    file: str                 # "repro_torch/core/bfs.py" ("" = none found)
    line: int
    via: str                  # "host_read" | "sync" (sync debug mode)

    @property
    def site(self) -> str:
        return f"{self.file}:{self.line}"


@dataclasses.dataclass
class Role:
    """One exchange the plan prices: what the census must account for."""

    name: str
    kinds: tuple              # collective kinds this strategy may make
    model_bytes: float        # modeled bytes received per chip per instance
    group: Optional[int]      # expected group size (None: skip)
    required: bool            # must appear in the loop at least once
    per_op: bool = True       # True: each op ~ model; False: each level's
                              # sum(ops) ~ model

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _recv_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Bytes received per participant given the op's output bytes."""
    if g <= 1:
        return 0.0
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return out_bytes * 2 * (g - 1) / g     # ring lower bound
    return out_bytes                            # collective-permute et al.


def _strategies(plan) -> dict:
    """``{kind: strategy}`` of the plan's resolved exchanges."""
    if plan.partition == "2d":
        return {"expand_row": plan.expand_strategy,
                "fold_col": plan.fold_strategy,
                "expand_row_sparse": plan.expand_sparse_strategy,
                "fold_col_sparse": plan.fold_sparse_strategy}
    return {"dense": plan.dense_strategy, "queue": plan.queue_strategy}


def _call_site(frame) -> tuple:
    """``(file, line)`` of the innermost port frame outside the mesh and
    this module (``file`` as ``repro_torch/core/bfs.py``; ``("", 0)``:
    none)."""
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PKG_DIR) and path not in _SKIP_FILES:
            return (os.path.relpath(path, _SRC_DIR).replace(os.sep, "/"),
                    frame.f_lineno)
        frame = frame.f_back
    return "", 0


def _role_hint(frame, impls: dict, phase: str, kind: str) -> tuple:
    """``(hint, strategy)``: the role a collective of ``kind`` made in
    ``phase`` (the kind the runner announced) plays.  An all-reduce is
    the loop's control plane (no role); a bottom-up level's collective is
    the bottom-up gather; in a dense, queue or escalated level the
    innermost frame running a plan strategy's ``impl`` (``impls``: code
    -> [(kind, name)]) of that level's kinds names it, and a queue
    collective outside every strategy is the sieve's summary gather."""
    if kind == "all-reduce":
        return "", ""
    if phase == "bottom_up":
        return "bottom_up", ""
    want = {"dense": "dense", "escalated": "dense",
            "queue": "queue"}.get(phase)
    if want is None:
        return "", ""
    while frame is not None:
        found = [(k, nm) for k, nm in impls.get(frame.f_code, ())
                 if _KIND_LEVEL[k] == want]
        if found:
            kind, name = found[0]
            return _KIND_ROLE[kind], f"{kind}:{name}"
        frame = frame.f_back
    return ("sieve", "") if want == "queue" else ("", "")


class RecordingMesh:
    """A wrapper of a mesh (a ``LocalMesh`` or this rank's ``DistMesh``)
    that records every collective and host read of the level loop
    (``ops``: ``CollectiveOp`` rows, ``reads``: ``HostRead`` rows), then
    runs it as the wrapped mesh does; anything else it reads from the
    wrapped mesh.

    It compares and hashes as the wrapped mesh, so an engine planned on
    it shares the device blocks of the engines planned on that mesh
    (``DeviceBlockCache`` keys on the mesh).
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.ops, self.reads, self.levels = [], [], {}
        self.escalated, self._impls = set(), {}
        self._level, self._phase = 0, "outside"

    @classmethod
    def like(cls, mesh, plan) -> "RecordingMesh":
        """A recording twin of ``mesh``; ``plan`` names the strategies
        whose collectives it attributes."""
        rec = cls(mesh)
        for kind, st in _strategies(plan).items():
            rec._impls.setdefault(st.impl.__code__, []).append(
                (kind, st.name))
        return rec

    def __getattr__(self, name):
        return getattr(self.__dict__["mesh"], name)

    def __eq__(self, other):
        return self.mesh == (other.mesh if isinstance(other, RecordingMesh)
                             else other)

    def __hash__(self):
        return hash(self.mesh)

    def enter_level(self, level: int, kind: str) -> None:
        self._level, self._phase = level, kind
        if kind in _bfs.LEVEL_KINDS:
            self.levels[level] = kind
        elif kind == "escalated":
            self.escalated.add(level)

    def where(self) -> tuple:
        """``(level, level_kind)`` of the code running now: the announced
        level's kind, or "sources" / "outside" at level 0."""
        return self._level, self.levels.get(self._level, self._phase)

    def _record(self, kind: str, x: torch.Tensor, y: torch.Tensor, axis):
        g = self.axis_size(axis)
        out_bytes = float(math.prod(y.shape[1:]) * y.element_size())
        level, level_kind = self.where()
        frame = sys._getframe(2)
        hint, strategy = _role_hint(frame, self._impls, self._phase, kind)
        file, line = _call_site(frame)
        self.ops.append(CollectiveOp(
            kind=kind, out_bytes=out_bytes,
            recv_bytes=_recv_bytes(kind, out_bytes, g), group_size=g,
            n_groups=self.p // g, in_loop=level > 0,
            source=f"{os.path.basename(file)}:{line}" if file else "",
            level=level, level_kind=level_kind, strategy=strategy,
            hint=hint, axis=str(axis), in_shape=tuple(x.shape[1:]),
            out_shape=tuple(y.shape[1:]),
            dtype=str(y.dtype).replace("torch.", "")))

    def all_to_all(self, x, axis):
        y = self.mesh.all_to_all(x, axis)
        self._record("all-to-all", x, y, axis)
        return y

    def all_gather(self, x, axis):
        y = self.mesh.all_gather(x, axis)
        self._record("all-gather", x, y, axis)
        return y

    def psum_scatter(self, x, axis):
        y = self.mesh.psum_scatter(x, axis)
        self._record("reduce-scatter", x, y, axis)
        return y

    def psum(self, x, axis):
        y = self.mesh.psum(x, axis)
        self._record("all-reduce", x, y, axis)
        return y

    def pmax(self, x, axis):
        y = self.mesh.pmax(x, axis)
        self._record("all-reduce", x, y, axis)
        return y

    def host_read(self, x):
        out = self.mesh.host_read(x)
        self.reads.append(HostRead(*self.where(),
                                   *_call_site(sys._getframe(1)),
                                   "host_read"))
        return out


@contextlib.contextmanager
def _sync_capture(mesh: RecordingMesh, into: Optional[list]):
    """Append a ``HostRead`` to ``into`` for every synchronizing CUDA call
    (``torch.cuda.set_sync_debug_mode("warn")``) made inside, filed under
    ``mesh``'s level; a no-op when ``into`` is None (off a card)."""
    if into is None:
        yield
        return
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                shown(message, category, filename, lineno, file, line)
                return
            into.append(HostRead(*mesh.where(),
                                 *_call_site(sys._getframe(1)), "sync"))

        warnings.showwarning = hook
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


@dataclasses.dataclass
class Recording:
    """One recorded traversal: its collectives, host reads (and, on a
    card, synchronizing calls), each level's kind, and its result."""

    ops: List[CollectiveOp]
    reads: List[HostRead]
    syncs: Optional[List[HostRead]]     # None off a card
    levels: dict                        # level -> kind
    escalated: set                      # queue levels that ran dense
    result: object                      # the twin engine's BFSResult

    def budget_kind(self, level: int, kind: str) -> str:
        """The ``HOST_READ_BUDGET`` key of a level."""
        return "escalated" if level in self.escalated else kind

    def reached(self) -> set:
        """The level kinds of ``_ROLE_LEVEL`` the traversal ran."""
        kinds = set(self.levels.values())
        out = {k for k in kinds if k in ("dense", "queue", "bottom_up")}
        if self.escalated:
            out.add("dense")
        if any(k == "queue" and lv not in self.escalated
               for lv, k in self.levels.items()):
            out.add("queue_sparse")
        return out


def default_sources(plan) -> list:
    """The audited traversal's sources: vertices ``0..S-1`` (as
    ``bfs_run``'s first run)."""
    return list(range(min(plan.num_sources, plan.graph.part.n_logical)))


def record(engine, sources: Optional[Sequence[int]] = None) -> Recording:
    """Drive one traversal of ``engine``'s plan on a ``RecordingMesh``.

    The recording runs on a twin engine of the same plan whose mesh is
    the recording mesh: it shares the engine's device blocks and makes
    its own ``(n, S)`` buffers, so ``engine`` itself is not touched.
    """
    plan = engine.plan
    mesh = RecordingMesh.like(plan.mesh, plan)
    twin = _engine.BFSEngine(dataclasses.replace(plan, mesh=mesh))
    srcs = default_sources(plan) if sources is None else list(sources)
    # a host transport synchronizes in every collective: count host_read
    syncs = ([] if plan.device.type == "cuda"
             and not getattr(plan.mesh, "collectives_sync", False) else None)
    with _sync_capture(mesh, syncs):
        res = twin.run(srcs)
    return Recording(mesh.ops, mesh.reads, syncs, dict(mesh.levels),
                     set(mesh.escalated), res)


def census(engine, sources: Optional[Sequence[int]] = None
           ) -> List[CollectiveOp]:
    """Every collective of one traversal of ``engine``'s plan."""
    return record(engine, sources).ops


def _strategy_kinds(name: str) -> tuple:
    """Collective kinds a registered exchange strategy may make.

    Packed reduce-scatter twins route word blocks via all_to_all (a sum
    carries across bit lanes), so only the bytes-tier ``reduce_scatter``
    names make a reduce-scatter.
    """
    if "hierarchical" in name:
        return ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
                "collective-permute")
    if "reduce_scatter" in name and not name.endswith("_packed"):
        return ("reduce-scatter", "all-reduce")
    if "alltoall" in name or "reduce_scatter" in name:
        return ("all-to-all",)
    if "allgather" in name:
        return ("all-gather",)
    return ("all-to-all", "all-gather", "reduce-scatter")


def roles_for_plan(plan) -> List[Role]:
    """Derive the expected census roles from a resolved BFSPlan.

    Reachability mirrors core/bfs.py: dense runs in every mode (it is
    the queue path's overflow escalation), the sparse path needs S=1,
    bottom-up exists only under ``auto``, and the sieve gather rides
    inside each queue level when the plan resolved it on.  A role with a
    zero byte model (p=1, or a peerless grid axis) is never required —
    its collective moves nothing.

    Fused-tail plans (``use_fused_tail``) change the *compute* between
    collectives — the fold merge, owner update and next-frontier pack
    collapse into kernel A1 fed by the carried word generation — but
    ship the same payloads through the same collectives, so the role set
    and every byte model are identical to the unfused twin.  The
    48-variant gate audits both twins per wire x mode and this
    invariance is exactly what HA001-HA003 then verify.
    """
    d = plan.describe()
    mode, s = d["mode"], d["num_sources"]
    queue_reachable = mode == "queue" or (mode == "auto" and s == 1)
    roles: List[Role] = []

    def role(name, strategy_name, model, group, required, per_op=True,
             kinds=None):
        roles.append(Role(
            name=name,
            kinds=kinds or _strategy_kinds(strategy_name),
            model_bytes=float(model), group=group,
            required=bool(required and model > 0), per_op=per_op))

    if d["partition"] == "2d":
        r, c = d["grid"]
        p = r * c
        pb = d["phase_bytes"]
        role("expand", d["expand_exchange"], pb["expand"],
             c if c > 1 else None, True)
        role("fold", d["fold_exchange"], pb["fold"],
             r if r > 1 else None, True)
        if queue_reachable:
            role("expand_sparse", d["expand_sparse_exchange"],
                 pb["expand_sparse"], c if c > 1 else None, True)
            role("fold_sparse", d["fold_sparse_exchange"],
                 pb["fold_sparse"], r if r > 1 else None, True)
            if d["sieve"]:
                b = d["shard_size"]
                sieve_b = (p - 1) * fr.sieve_layout(b)[2] * 4
                role("sieve", "allgather", sieve_b, None, True,
                     per_op=False, kinds=("all-gather",))
        if mode == "auto":
            role("bottom_up", "allgather", d["bottom_up_level_bytes"],
                 None, True, per_op=False, kinds=("all-gather",))
    else:
        p = d["p"]
        role("dense", d["dense_exchange"], d["dense_level_bytes"],
             p if len(d["axes_sizes"]) == 1 else None, True)
        if queue_reachable:
            sieve_b = ((p - 1) * fr.sieve_layout(d["shard_size"])[2] * 4
                       if d["sieve"] else 0.0)
            role("queue", d["queue_exchange"],
                 d["queue_level_bytes"] - sieve_b, p, True)
            if d["sieve"]:
                role("sieve", "allgather", sieve_b, p, True,
                     per_op=False, kinds=("all-gather",))
        if mode == "auto":
            role("bottom_up", "allgather",
                 ex.bottomup_level_bytes(d["n"], p, s, 1,
                                         wire=plan.bottom_up_wire),
                 p, True, per_op=False, kinds=("all-gather",))
    return roles


def match_census(ops: Sequence[CollectiveOp], roles: Sequence[Role],
                 report: AuditReport, tolerance=DEFAULT_TOLERANCE,
                 reached: Optional[set] = None) -> dict:
    """Assign loop collectives to roles and assert the byte accounting.

    A collective whose stack named its role (``hint``) goes to that role;
    the rest go greedily, as JAX assigns every HLO op, to the candidate
    role (kind-compatible, nonzero model) whose model is nearest in log
    space.  ``reached`` (the level kinds a recorded traversal ran; None:
    all) turns a missing role whose level kind never ran into an
    ``info`` row.  Violations land on ``report``; returns {role: [ops]}.
    """
    lo, hi = tolerance
    assigned = {role.name: [] for role in roles}
    names = set(assigned)
    for op in ops:
        if not op.in_loop:
            op.role = "outside_loop"
            continue
        if op.kind == "all-reduce" and op.out_bytes <= CONTROL_CUTOFF:
            op.role = "control"
            continue
        if op.group_size <= 1 or op.recv_bytes <= 0:
            # a collective over a group of one moves no data
            op.role = "degenerate"
            continue
        cands = [role for role in roles
                 if op.kind in role.kinds and role.model_bytes > 0
                 and (op.hint not in names or role.name == op.hint)]
        if not cands:
            op.role = "unpriced"
            made_by = op.strategy or op.hint or "no strategy"
            report.add("HA002",
                       f"{op.kind} at {op.source or '?'} in level "
                       f"{op.level} ({op.level_kind}; {made_by}; "
                       f"{op.recv_bytes:.0f} B received, group "
                       f"{op.group_size}) matches no plan byte model")
            continue
        best = min(cands, key=lambda role: abs(
            math.log(max(op.recv_bytes, 1e-9) / role.model_bytes)))
        op.role = best.name
        op.model_bytes = best.model_bytes
        assigned[best.name].append(op)

    # exact size ties (e.g. the packed bottom-up gather and the sieve
    # gather both ship W uint32 words per shard) can strand a required
    # role while its twin collects both ops — let an empty required
    # role steal a tolerance-compatible unnamed op from a role holding
    # several
    for role in roles:
        if assigned[role.name] or not role.required:
            continue
        donors = [op for other in roles
                  if other.name != role.name
                  and len(assigned[other.name]) > 1
                  for op in assigned[other.name]
                  if not op.hint and op.kind in role.kinds
                  and lo <= op.recv_bytes / role.model_bytes <= hi]
        if donors:
            op = min(donors, key=lambda o: abs(
                math.log(o.recv_bytes / role.model_bytes)))
            assigned[op.role].remove(op)
            op.role = role.name
            op.model_bytes = role.model_bytes
            assigned[role.name].append(op)

    for role in roles:
        matched = assigned[role.name]
        if not matched:
            if role.required:
                where = _ROLE_LEVEL.get(role.name, "")
                unseen = reached is not None and where not in reached
                report.add("HA001",
                           f"role '{role.name}' (model "
                           f"{role.model_bytes:.0f} B, kinds "
                           f"{'/'.join(role.kinds)}) has no collective in "
                           + (f"the traversal: it ran no {where} level"
                              if unseen else "any level of its kind"),
                           severity="info" if unseen else "error")
            continue
        if role.per_op:
            for op in matched:
                ratio = op.recv_bytes / role.model_bytes
                if not lo <= ratio <= hi:
                    report.add("HA003",
                               f"role '{role.name}' at {op.source} in "
                               f"level {op.level}: recorded "
                               f"{op.recv_bytes:.0f} B received vs model "
                               f"{role.model_bytes:.0f} B "
                               f"(ratio {ratio:.3f} outside "
                               f"[{lo}, {hi}])")
        else:
            by_level = collections.defaultdict(list)
            for op in matched:
                by_level[op.level].append(op)
            for level, level_ops in sorted(by_level.items()):
                total = sum(op.recv_bytes for op in level_ops)
                ratio = total / role.model_bytes
                if not lo <= ratio <= hi:
                    report.add("HA003",
                               f"role '{role.name}' in level {level}: "
                               f"recorded {total:.0f} B received over "
                               f"{len(level_ops)} op(s) vs model "
                               f"{role.model_bytes:.0f} B (ratio "
                               f"{ratio:.3f} outside [{lo}, {hi}])")
        if role.group:
            for op in matched:
                if op.group_size and op.group_size != role.group:
                    report.add("HA007",
                               f"role '{role.name}' at {op.source} in "
                               f"level {op.level}: group size "
                               f"{op.group_size} != expected "
                               f"{role.group}")
    return assigned


def host_read_check(rec: Recording, report: AuditReport,
                    sites: Optional[set] = None) -> None:
    """HA005: each level reads the device within ``HOST_READ_BUDGET``, at
    a site the lint lists (a suppressed RX004 of ``lint.host_read_sites``,
    default: the tree's).  On a card the synchronizing calls are counted
    (every one, hidden or not), and a level with fewer of them than
    ``host_read`` calls means the count is blind."""
    sites = _lint.host_read_sites() if sites is None else sites
    counted = rec.syncs if rec.syncs is not None else rec.reads
    per_level = collections.Counter(
        (r.level, rec.budget_kind(r.level, r.level_kind)) for r in counted
        if r.level_kind != "outside")
    reads = collections.Counter(
        (r.level, rec.budget_kind(r.level, r.level_kind)) for r in rec.reads
        if r.level_kind != "outside")
    for (level, kind), n in sorted(per_level.items()):
        budget = HOST_READ_BUDGET[kind]
        if n > budget:
            report.add("HA005",
                       f"level {level} ({kind}) read the device {n} times "
                       f"(budget {budget}): "
                       + ", ".join(r.site for r in counted
                                   if r.level == level))
    if rec.syncs is not None:
        for key, n in sorted(reads.items()):
            if per_level.get(key, 0) < n:
                report.add("HA005",
                           f"level {key[0]} ({key[1]}): {n} host reads "
                           f"but {per_level.get(key, 0)} synchronizing "
                           "calls seen: the sync count is blind")
    for r in counted:
        if r.level_kind != "outside" and (r.file, r.line) not in sites:
            report.add("HA005",
                       f"level {r.level} ({r.level_kind}) reads the device "
                       f"at {r.site or 'an unknown site'} ({r.via}), not a "
                       "site listed with allow(RX004)")
    worst = collections.defaultdict(int)
    for (_, kind), n in per_level.items():
        worst[kind] = max(worst[kind], n)
    report.info["host_reads"] = {
        "counted_by": "sync" if rec.syncs is not None else "host_read",
        "levels": len(rec.levels),
        "max_per_level": dict(worst), "budget": HOST_READ_BUDGET,
        "sites": sorted({r.site for r in counted
                         if r.level_kind != "outside"})}


def coverage_check(rec: Recording, p: int, report: AuditReport) -> None:
    """HA001 for a census that saw nothing: the traversal announced no
    level, or, at p > 1, made no collective inside one.  Every level of a
    traversal exchanges at p > 1, so either means the recording lost the
    level loop and the role checks would pass over an empty census."""
    if not rec.levels:
        report.add("HA001", "the traversal announced no level "
                   "(enter_level): the census saw none of the level loop")
    elif p > 1 and not any(op.in_loop for op in rec.ops):
        report.add("HA001", f"no collective inside any of the "
                   f"{len(rec.levels)} levels at p = {p}: the census saw "
                   "none of the level loop's exchanges")


def donation_check(engine, report: AuditReport) -> None:
    """HA004: two runs of ``engine`` reuse its ``(n, S)`` dist and
    frontier buffers (the counterpart of JAX's donated dist buffer); each
    result's ``dist`` is the engine's buffer."""
    n_logical = engine.plan.graph.part.n_logical
    engine.settle()
    ptrs = (engine._dist.data_ptr(), engine._frontier.data_ptr())
    for srcs in ([0], [1 if n_logical > 1 else 0]):
        res = engine.run(srcs)
        now = (engine._dist.data_ptr(), engine._frontier.data_ptr())
        if now != ptrs or res.dist.data_ptr() != ptrs[0]:
            report.add("HA004",
                       f"run from {srcs}: dist/frontier at "
                       f"{now}, result at {res.dist.data_ptr()}, "
                       f"not the engine's buffers {ptrs}: the engine "
                       "reallocated them")
            break
        res.dist_host                      # free the buffer for the next run
    report.info["donation"] = {"dist_reused": "HA004" not in report.rules()}


def retrace_check(engine, report: AuditReport) -> None:
    """HA006: two distinct-source runs must not grow the trace count."""
    n_logical = engine.plan.describe()["n_logical"]
    if n_logical < 2:
        return
    engine.settle()
    engine.run([0]).dist_host
    engine.run([1]).dist_host
    if engine.trace_count != engine.compile_traces:
        report.add("HA006",
                   f"trace_count {engine.trace_count} != compile_traces "
                   f"{engine.compile_traces} after two runs — the engine "
                   "retraced after compile")
    report.info["trace_count"] = engine.trace_count


def variant_name(plan) -> str:
    d = plan.describe()
    fused = ":fused" if getattr(plan, "use_fused_tail", False) else ""
    return (f"census:{d['partition']}:{d['mode']}:"
            f"{plan.opts.wire_format}:S{d['num_sources']}{fused}")


def _ratios(assigned: dict, roles: Sequence[Role]) -> dict:
    """Recorded over modeled bytes per role: the least and the most (a
    per-level sum for ``per_op=False`` roles)."""
    out = {}
    for role in roles:
        ops = assigned.get(role.name) or []
        if not ops or role.model_bytes <= 0:
            continue
        if role.per_op:
            vals = [op.recv_bytes / role.model_bytes for op in ops]
        else:
            per = collections.defaultdict(float)
            for op in ops:
                per[op.level] += op.recv_bytes
            vals = [v / role.model_bytes for v in per.values()]
        out[role.name] = {"min": min(vals), "max": max(vals),
                          "ops": len(ops)}
    return out


def audit_engine(engine, tolerance=DEFAULT_TOLERANCE,
                 run_check: bool = False, name: Optional[str] = None,
                 sources: Optional[Sequence[int]] = None,
                 on_result: Optional[Callable] = None) -> AuditReport:
    """Run every check against a compiled engine: one recorded traversal
    from ``sources`` (default ``default_sources``; ``on_result(result)``
    sees its ``BFSResult``), the buffer reuse check and, with
    ``run_check``, the retrace check."""
    plan = engine.plan
    report = AuditReport(name or variant_name(plan))
    rec = record(engine, sources)
    if on_result is not None:
        on_result(rec.result)
    roles = roles_for_plan(plan)
    coverage_check(rec, plan.mesh.p, report)
    assigned = match_census(rec.ops, roles, report, tolerance=tolerance,
                            reached=rec.reached())
    host_read_check(rec, report)
    donation_check(engine, report)
    if run_check:
        retrace_check(engine, report)
    d = plan.describe()
    kinds = collections.Counter(rec.levels.values())
    per_kind = collections.Counter(
        op.level_kind for op in rec.ops
        if op.role not in ("control", "outside_loop", "degenerate"))
    report.info.update({
        "tolerance": list(tolerance),
        "census": [op.to_dict() for op in rec.ops],
        "roles": [role.to_dict() for role in roles],
        "ratios": _ratios(assigned, roles),
        "plan": {k: d[k] for k in ("mode", "partition", "p", "n",
                                   "num_sources", "sieve", "wire_formats",
                                   "use_fused_tail")},
        "levels": dict(kinds),
        "reached": sorted(rec.reached()),
        "collectives": {
            "loop_data": sum(per_kind.values()),
            "loop_control": sum(1 for op in rec.ops
                                if op.role == "control"),
            "outside_loop": sum(1 for op in rec.ops if not op.in_loop),
            # data collectives a level, by the level's kind
            "per_level": {k: per_kind[k] / kinds[k] for k in kinds},
        },
    })
    return report


def census_table(report: AuditReport) -> str:
    """Render a report's census next to the modeled bytes (CLI output):
    one row per distinct priced collective, with the levels it ran in
    (the control all-reduces are counted in ``info["collectives"]``)."""
    rows = ["role          kind            group  level kind  recv B"
            "       model B      ratio   ops  levels      source"]
    groups = collections.OrderedDict()
    for op in report.info.get("census", ()):
        if not op["in_loop"] or op["role"] == "control":
            continue
        key = (op["role"], op["kind"], op["group_size"], op["level_kind"],
               op["recv_bytes"], op["model_bytes"], op["source"])
        groups.setdefault(key, []).append(op["level"])
    for (role, kind, g, lkind, recv, model, source), levels in \
            groups.items():
        ratio = f"{recv / model:7.3f}" if model else "      -"
        span = (f"{min(levels)}-{max(levels)}" if len(set(levels)) > 1
                else str(levels[0]))
        rows.append(f"{role or '?':<13} {kind:<15} {g:>5}  {lkind:<10}  "
                    f"{recv:>10.0f}  {model:>10.0f}  {ratio}  "
                    f"{len(levels):>4}  {span:<10}  {source}")
    return "\n".join(rows)
