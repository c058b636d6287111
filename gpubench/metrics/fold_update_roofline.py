"""``fold_update_roofline``: kernel A1 (``fold_update_kernel``, the
owner update)'s byte floor over its time, summed over every launch of the
traced batches, in %.

The floor is ``yardstick.fold_update_bytes``: what A1's contract has to
move, not what the present kernel moves.  Its reached (vertex, root)
pairs come from the benchmark's own component labels of its edge list
and the traced batches' roots, never from the program's state.  One
launch a level: nothing is read where the trace holds no A1 launch or
another count than the traced levels."""

from gpubench import graph500, yardstick


def read(run):
    if run.trace is None or not run.traced:
        return None
    launches, seconds = run.trace.kernel("fold_update_kernel")
    levels = sum(len(levels) for levels in run.traced)
    if not launches or launches != levels:
        return None
    labels = graph500.component_labels(run.graph.src, run.graph.dst,
                                       run.graph.n, run.device)
    reached = sum(yardstick.reached_pairs(labels, roots)
                  for roots in run.traced_roots)
    shard = yardstick.partition(run.graph.n, run.p)["shard"]
    nbytes = yardstick.fold_update_bytes(run.p, shard, run.sources, levels,
                                         reached)
    return yardstick.bound_s(nbytes) / seconds * 100.0
