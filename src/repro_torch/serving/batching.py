"""Continuous batching scheduler (host-side), slot-based (the port of
``repro/serving/batching.py``).

A fixed pool of B slots shares one KV cache; requests are admitted into free
slots (their prompt prefilled into the slot's cache region through the
decode path), and every engine step decodes one token for all live slots.

``SlotScheduler`` is the admission policy factored out of the batcher —
bounded in-flight window, FIFO-within-priority queue, optional per-key
quotas — pure Python, copied from the reference for the cohort-query
service to share later (ROADMAP A7).

Two faults of the reference's batcher are kept, so that the port gives the
reference's tokens (ROADMAP C9): ``_single_token`` decodes every slot while
a prompt is admitted, which writes token 0's K/V at the prompt's position
into every other live slot's cache, and ``step`` decodes all live slots at
the position of the first.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.registry import ModelBundle
from repro_torch.serving.serve_step import make_serve_step

__all__ = ["Request", "ContinuousBatcher", "SlotScheduler"]


class SlotScheduler:
    """Slot-based admission: a bounded in-flight window over a FIFO-with-
    priority queue, with optional per-key (per-tenant) in-flight quotas and a
    bounded queue depth.

    Items are ``submit``-ted with a key and a priority; ``admit`` moves as
    many queued items as free slots (and quotas) allow, in priority order
    (higher first) then submission order; ``release(key)`` retires one slot.
    Over-quota items stay queued *in place* — later items of other keys may
    overtake them, but order within a key is always FIFO: the heap entries
    carry a monotonic sequence counter, so equal-priority items never fall
    through to comparing ``key``/``item`` (which may not be orderable at
    all) and never reorder within a priority band.

    Thread-safe: the cohort-query service releases slots from its
    realization worker while the main thread admits, so every mutation
    holds an internal lock.
    """

    def __init__(self, n_slots: int, per_key_quota: Optional[int] = None,
                 max_queue: Optional[int] = None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = int(n_slots)
        self.per_key_quota = per_key_quota
        self.max_queue = max_queue
        self._heap: List[Tuple[int, int, Any, Any]] = []  # (-prio, seq, key, item)
        self._seq = itertools.count()
        self._inflight: Dict[Any, int] = {}
        self._live = 0
        self._lock = threading.Lock()

    def queued(self) -> int:
        with self._lock:
            return len(self._heap)

    def inflight(self) -> int:
        with self._lock:
            return self._live

    def submit(self, item: Any, key: Any = None, priority: int = 0) -> bool:
        """Enqueue; returns False (rejecting the item) when the queue is
        at ``max_queue`` depth."""
        with self._lock:
            if self.max_queue is not None \
                    and len(self._heap) >= self.max_queue:
                return False
            heapq.heappush(self._heap,
                           (-int(priority), next(self._seq), key, item))
            return True

    def admit(self, select: Optional[Callable[[Any], bool]] = None
              ) -> List[Tuple[Any, Any]]:
        """Fill free slots from the queue; returns admitted ``(item, key)``
        pairs in admission order.  ``select`` (the port's addition) admits
        exactly the queued items it accepts, in queue order, whatever the
        free slots and quotas: a follower replaying another scheduler's
        admission (the sharded query service's ranks follow rank 0's), whose
        own releases may still be on their way."""
        admitted: List[Tuple[Any, Any]] = []
        skipped: List[Tuple[int, int, Any, Any]] = []
        with self._lock:
            while self._heap and (select is not None
                                  or self._live < self.n_slots):
                entry = heapq.heappop(self._heap)
                _, _, key, item = entry
                if select is not None:
                    if not select(item):
                        skipped.append(entry)
                        continue
                elif (self.per_key_quota is not None
                        and self._inflight.get(key, 0) >= self.per_key_quota):
                    skipped.append(entry)  # over quota: stays queued in place
                    continue
                self._inflight[key] = self._inflight.get(key, 0) + 1
                self._live += 1
                admitted.append((item, key))
            for entry in skipped:
                heapq.heappush(self._heap, entry)
        return admitted

    def release(self, key: Any = None) -> None:
        """Retire one in-flight item admitted under ``key``."""
        with self._lock:
            if self._live <= 0:
                raise RuntimeError("release() without a live admission")
            self._live -= 1
            left = self._inflight.get(key, 0) - 1
            if left > 0:
                self._inflight[key] = left
            else:
                self._inflight.pop(key, None)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching over one cache of ``n_slots`` rows on
    the parameters' device; ``engine`` is the attention engine."""

    def __init__(self, bundle: ModelBundle, params, n_slots: int, kv_len: int,
                 eos_id: int = 2, engine: str = "auto"):
        self.bundle = bundle
        self.params = params
        self.n_slots = n_slots
        self.kv_len = kv_len
        self.eos_id = eos_id
        self.device = params["embed"].device
        self.cache = bundle.init_cache(n_slots, kv_len, device=self.device)
        self.step_fn = make_serve_step(bundle, sample=True, engine=engine)
        self.sched = SlotScheduler(n_slots)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_remaining = np.zeros(n_slots, np.int32)
        self.cur_token = np.zeros(n_slots, np.int32)

    def submit(self, req: Request) -> None:
        self.sched.submit(req, key=req.rid)

    def _admit(self) -> None:
        for req, _ in self.sched.admit():
            i = next(j for j in range(self.n_slots) if self.slots[j] is None)
            self.slots[i] = req
            # prefill the prompt token-by-token through the decode path
            for t, tok in enumerate(req.prompt[:-1]):
                self._single_token(i, tok, t)
            self.slot_pos[i] = len(req.prompt) - 1
            self.cur_token[i] = req.prompt[-1]
            self.slot_remaining[i] = req.max_new

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.device)

    def _single_token(self, slot: int, token: int, pos: int) -> None:
        # decodes EVERY slot, the others with token 0 (ROADMAP C9)
        toks = np.zeros((self.n_slots, 1), np.int32)
        toks[slot, 0] = token
        batch = {"tokens": self._tokens(toks), "pos": int(pos)}
        _, self.cache = self.step_fn(self.params, self.cache, batch)

    def step(self) -> int:
        """One engine step; returns number of live slots."""
        self._admit()
        live = [i for i in range(self.n_slots) if self.slots[i] is not None]
        if not live:
            return 0
        toks = self._tokens(self.cur_token.reshape(-1, 1).copy())
        # all slots decode at the first live slot's position (ROADMAP C9)
        pos = int(self.slot_pos[live[0]])
        out, self.cache = self.step_fn(self.params, self.cache,
                                       {"tokens": toks, "pos": pos})
        out = out.cpu().numpy()
        for i in live:
            tok = int(out[i])
            req = self.slots[i]
            req.out.append(tok)
            self.cur_token[i] = tok
            self.slot_pos[i] += 1
            self.slot_remaining[i] -= 1
            if tok == self.eos_id or self.slot_remaining[i] <= 0 \
                    or self.slot_pos[i] >= self.kv_len - 1:
                req.done = True
                self.slots[i] = None
                self.sched.release(req.rid)
        return len(live)

    def run(self, max_steps: int = 1_000) -> None:
        for _ in range(max_steps):
            if not self.step() and not self.sched.queued():
                break
