"""``level_enqueue_ms``: ms a traced level spends outside its device read,
each ``bfs.level`` span less its ``bfs.host_read`` spans
(``repro_torch.core.spans``): the host's own work a level, enqueuing the
level's device work."""

from gpubench import recorder


def read(run):
    split = recorder.level_split_ms(run)
    return None if split is None else split[1]
