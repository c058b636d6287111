"""``batch_ms_p95``: the 95th percentile of every batch's time in the
window, from the call to ``run`` until its distances are complete on the
card (host clock; ``run`` synchronises)."""

import numpy as np


def read(run):
    if not run.batches:
        return None
    return float(np.percentile([b.seconds for b in run.batches], 95)) * 1e3
