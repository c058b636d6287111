"""``setup.tile_build_s``: host seconds of the one-bit tile build under
``use_kernel``, the program's ``engine.tile_build`` span
(``repro_torch.core.spans``; ``bsr_bit_shards`` and ``block_row_ptr``,
inside ``setup.compile_s``)."""

from gpubench import recorder


def read(run):
    return recorder.setup_seconds(run, "engine.tile_build")
