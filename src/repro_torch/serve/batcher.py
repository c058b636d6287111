"""Fixed-size slot scheduler of the traversal service — the port of
``repro.serve.batcher``'s ``SlotPool``.

The pool packs concurrent single-source traversal requests into the
source columns of one multi-source engine run (serve/bfs_service.py).
The JAX module's LM continuous-batching ``Server`` waits for the port's
decode step.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np


class SlotPool:
    """Fixed-size slot scheduler: queued requests fill free slots, finished
    slots are recycled without draining the batch.

    The pool only requires items to expose a boolean ``done`` attribute.
    The BFS traversal service (serve/bfs_service.py) batches concurrent
    source requests into one multi-source engine run with it.
    """

    def __init__(self, n_slots: int):
        self.slots: List[Optional[Any]] = [None] * n_slots
        self.queue: List[Any] = []

    def __len__(self) -> int:
        return len(self.slots)

    def submit(self, item) -> None:
        self.queue.append(item)

    def admit(self) -> List[tuple]:
        """Fill free (empty or finished) slots from the queue in FIFO
        order; returns the (slot_index, item) placements made."""
        placed = []
        for i, cur in enumerate(self.slots):
            if (cur is None or cur.done) and self.queue:
                item = self.queue.pop(0)
                self.slots[i] = item
                placed.append((i, item))
        return placed

    def live(self) -> np.ndarray:
        """(n_slots,) bool — slots holding an unfinished item."""
        return np.array([r is not None and not r.done for r in self.slots])

    def drained(self) -> bool:
        return not self.queue and all(
            r is None or r.done for r in self.slots)
