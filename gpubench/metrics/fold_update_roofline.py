"""``fold_update_roofline``: kernel A1 (``fold_update_kernel``)'s byte
bound over its time, summed over every launch of the traced batches, in %.
Bytes a launch from its shapes (``yardstick.fold_update_bytes``); one
launch a level.  Nothing is read where the trace holds no A1 launch or
another count than the traced levels."""

from gpubench import yardstick


def read(run):
    if run.trace is None or not run.traced:
        return None
    launches, seconds = run.trace.kernel("fold_update_kernel")
    levels = sum(len(levels) for levels in run.traced)
    if not launches or launches != levels:
        return None
    shard = yardstick.partition(run.graph.n, run.p)["shard"]
    nbytes = levels * yardstick.fold_update_bytes(run.p, shard, run.sources)
    return yardstick.bound_s(nbytes) / seconds * 100.0
