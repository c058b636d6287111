"""``expand_tiles_read_share.bits``: the tiles ``bsr_expand_bits_kernel``
read over the tiles it held, summed over every launch of the traced
batches, in %.  The kernel counts the tiles it reads itself (the
program's device counter ``bsr_expand_bits.tiles_read``); the program
counts ``bsr_expand_bits.tiles_held`` (K a launch) and the launches.
Nothing is read where the launches are not the traced levels."""

from gpubench import recorder


def read(run):
    got = recorder.traced_levels(run)
    if got is None:
        return None
    counts = got[0].counters
    levels = sum(len(batch) for batch in run.traced)
    held = counts.get("bsr_expand_bits.tiles_held", 0)
    if (counts.get("bsr_expand_bits.launches") != levels or not held
            or "bsr_expand_bits.tiles_read" not in counts):
        return None
    return counts["bsr_expand_bits.tiles_read"] / held * 100.0
