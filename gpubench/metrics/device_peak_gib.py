"""``device_peak_gib``: ``torch.cuda.max_memory_allocated()`` over set-up
(from the sharding of the graph on) and the window, in GiB."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
