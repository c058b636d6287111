"""``gteps``: Graph500's traversed edges of every batch of the window,
over the window's seconds, in 1e9 a second (host clock)."""


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    return sum(b.edges for b in run.batches) / run.window_s / 1e9
