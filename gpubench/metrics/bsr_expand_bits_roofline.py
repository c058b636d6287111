"""``bsr_expand_bits_roofline``: ``bsr_expand_bits_kernel``'s byte bound
over its time, summed over every launch of the traced batches, in %.

A launch's bytes are ``chip_smoke.py``'s ``expand_bound``: the column
masks and block indices of every tile, the frontier and output words, and
only the tiles whose column mask meets some source's frontier word at that
level (``yardstick.TileModel``, from the benchmark's own edge list and the
traced batches' frontiers).  Nothing is read where the trace holds no
launch or another count than the traced levels."""

from gpubench import yardstick


def read(run):
    if run.trace is None or not run.traced:
        return None
    launches, seconds = run.trace.kernel("bsr_expand_bits_kernel")
    levels = sum(len(levels) for levels in run.traced)
    if not launches or launches != levels:
        return None
    model = yardstick.TileModel(run.graph.src, run.graph.dst, run.graph.n,
                                run.p, device=run.traced[0][0].device)
    nbytes = sum(model.launch_bytes(run.sources, model.tiles_read(front))
                 for batch in run.traced for front in batch)
    return yardstick.bound_s(nbytes) / seconds * 100.0
