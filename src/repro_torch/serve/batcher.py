"""Continuous batching over the LM decode step, and the slot scheduler it
shares with the traversal service — the port of ``repro.serve.batcher``.

``Server`` keeps a fixed-size decode batch whose slots sit at independent
depths: the decode step takes per-slot positions, each slot's k, v rows
land at its own depth and attention masks per-slot lengths.  Finished
slots are recycled for queued requests without draining the batch.  As
in the JAX module, a slot's prompt is fed token by token through the
decode step (slot-local prefill), after which the prompt's last token is
fed once more at the next position to give the first output token; an
inactive slot rewrites its own position; positions advance only on the
active mask; sampling is greedy (``argmax``, the first index among
ties).  ``SlotPool`` also packs concurrent single-source traversal
requests into one multi-source engine run (serve/bfs_service.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (L,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class SlotPool:
    """Fixed-size slot scheduler: queued requests fill free slots, finished
    slots are recycled without draining the batch.

    The pool only requires items to expose a boolean ``done`` attribute.
    Shared by the LM continuous-batching ``Server`` below and the BFS
    traversal service (serve/bfs_service.py), which batches concurrent
    source requests into one multi-source engine run.
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


class Server:
    """Greedy continuous batching of ``Request`` over ``batch_slots``
    slots of a ``max_len``-deep cache, on the device of ``params``."""

    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.pool = SlotPool(batch_slots)
        self.n_slots = batch_slots
        self.max_len = max_len
        self.device = params.embed.device
        self.cache = tf.init_cache(cfg, batch_slots, max_len,
                                   device=self.device)
        self.pos = np.zeros(batch_slots, dtype=np.int32)   # per-slot depth
        self._last_tok = np.zeros(batch_slots, dtype=np.int32)
        self.decode_steps = 0

    @property
    def slots(self) -> List[Optional[Request]]:
        return self.pool.slots

    def submit(self, req: Request):
        self.pool.submit(req)

    # --------------------------------------------------------------- core
    def _advance(self, active_mask: np.ndarray):
        """One decode step; slots advance at their own positions.  Inactive
        slots re-write their current position with their current token —
        a self-overwrite no-op — and their outputs are discarded."""
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        tok = torch.from_numpy(self._last_tok.copy()).to(self.device)
        logits, self.cache = tf.decode_step(self.cfg, self.params,
                                            self.cache, pos, tok)
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self.pos = np.where(active_mask, self.pos + 1, self.pos).astype(
            np.int32)
        self.decode_steps += 1
        return nxt

    def _admit(self):
        for i, req in self.pool.admit():
            self.pos[i] = 0
            # slot-local prefill: stream prompt tokens through decode,
            # advancing only this slot
            mask = np.zeros(self.n_slots, bool)
            mask[i] = True
            for tok in req.prompt:
                self._last_tok[i] = int(tok)
                self._advance(mask)
            self._last_tok[i] = int(req.prompt[-1])

    def step(self):
        """Admit + one decode step for every live slot; returns finished."""
        self._admit()
        live = self.pool.live()
        if not live.any():
            return []
        nxt = self._advance(live)
        finished = []
        for i in np.where(live)[0]:
            r = self.slots[i]
            r.out.append(int(nxt[i]))
            self._last_tok[i] = int(nxt[i])
            if (len(r.out) >= r.max_new_tokens
                    or self.pos[i] >= self.max_len - 1):
                r.done = True
                finished.append(r)
        return finished

    def run_until_drained(self, max_steps: int = 10_000):
        done = []
        for _ in range(max_steps):
            done += self.step()
            if self.pool.drained():
                break
        return done
