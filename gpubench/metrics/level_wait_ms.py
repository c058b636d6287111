"""``level_wait_ms``: ms a traced level spends in its device read, the
program's ``bfs.host_read`` spans directly under each ``bfs.level``
(``repro_torch.core.spans``): how long the host waits for the level's
device work."""

from gpubench import recorder


def read(run):
    split = recorder.level_split_ms(run)
    return None if split is None else split[0]
