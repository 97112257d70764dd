"""Request lifecycle + slot scheduler for continuous-batching serving.

The serving engine owns a FIXED array of B decode slots (one decode step
over all of them, finished/empty slots masked). This module owns the
host-side bookkeeping around that array:

* ``RequestHandle`` — the lifecycle object ``engine.submit`` returns:
  QUEUED -> RUNNING -> DONE | CANCELLED, a streaming ``tokens()`` iterator,
  and submit / first-token / finish timestamps.

* ``SlotScheduler`` — FIFO admission of queued requests into free slots,
  packed against a per-step FLOP budget: each request costs its compute
  budget (the roofline active-FLOP fraction its ``ElasticPolicy`` was
  solved for; 1.0 = full teacher row), and the queue head is admitted while
  the occupied cost sum stays within ``flop_budget``. Low-budget requests
  therefore co-schedule more densely. ``flop_budget=None`` means "one
  full-budget row per slot" (admission limited only by free slots).

This is the single-device, single-class subset of the JAX package's
``runtime/scheduler.py`` (same admission order and packing, the paged
engine's ``page_check`` and ``requeue_front`` included), copied so that the
port depends on nothing of that package. It has one replica: the replica
helpers (``replica_of``, ``free_slots_in``) exist for the paged engine's
calls. Replica sharding, tenant classes, deadlines, shedding and repricing
arrive with the mesh and SLO-controller slices (ROADMAP Queue A). The
scheduler imports no array library; the engine calls ``admit()`` /
``free()`` / ``tick()`` around its steps.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Deque, Iterator, List, Optional, Tuple

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"

# Admission-cost floor: a request whose roofline budget fraction rounds to
# ~0 FLOPs still occupies a decode-slot lane, so its scheduling cost can
# never be 0 — otherwise zero-cost rows bypass the FLOP budget entirely.
MIN_COST = 2.0 ** -10


class RequestHandle:
    """Lifecycle handle for one submitted request.

    ``tokens()`` is a pull-based stream: it yields tokens already produced
    and, while the request is live, drives ``engine.step()`` to produce
    more. ``done`` is True once the request reached any terminal state;
    ``output`` is the generated tokens so far (a list of ints).
    """

    _ids = itertools.count()

    def __init__(self, request, engine=None):
        self.id = next(self._ids)
        self.request = request
        self.status = QUEUED
        self.slot: Optional[int] = None
        self.output: List[int] = []
        self.finish_reason: Optional[str] = None   # length | eos | cancelled
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.budget_served: float = 1.0
        self._engine = engine

    @property
    def done(self) -> bool:
        return self.status in (DONE, CANCELLED)

    @property
    def latency(self) -> Optional[float]:
        """Submit -> finish wall time in seconds (None while live)."""
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first token in seconds (queue wait + prefill)."""
        return None if self.t_first is None else self.t_first - self.t_submit

    def append(self, tok: int):
        if self.t_first is None:
            self.t_first = time.perf_counter()
        self.output.append(tok)

    def finish(self, reason: str):
        self.status = CANCELLED if reason == "cancelled" else DONE
        self.finish_reason = reason
        self.t_done = time.perf_counter()

    def tokens(self) -> Iterator[int]:
        """Stream generated tokens; drives the engine while the request is
        live (each ``engine.step()`` advances every active slot, so
        consuming one stream also progresses concurrent requests)."""
        i = 0
        while True:
            while i < len(self.output):
                yield self.output[i]
                i += 1
            if self.done:
                return
            if self._engine is None:
                raise RuntimeError("detached handle cannot stream")
            self._engine.step()

    def result(self):
        """Block (stepping the engine) until done; returns the token list."""
        for _ in self.tokens():
            pass
        return list(self.output)

    def __repr__(self):
        return (f"RequestHandle(id={self.id}, status={self.status}, "
                f"slot={self.slot}, n_tokens={len(self.output)})")


class SlotScheduler:
    """FIFO admission into a fixed slot array under a per-step FLOP budget.

    ``cost`` of a request = its compute-budget fraction (1.0 for
    budget-None / teacher rows). The queue head is admitted into the lowest
    free slot while the occupied cost sum stays within ``flop_budget``;
    nothing jumps the queue. If nothing is running and the head alone
    exceeds the budget it is admitted anyway (progress guarantee).
    """

    def __init__(self, n_slots: int, flop_budget: Optional[float] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.flop_budget = (float(n_slots) if flop_budget is None
                            else float(flop_budget))
        self.slots: List[Optional[RequestHandle]] = [None] * n_slots
        self.costs: List[float] = [0.0] * n_slots
        self._queue: Deque[Tuple[RequestHandle, float]] = deque()
        # occupancy accounting (slot-steps used / slot-steps available)
        self.steps = 0
        self.active_slot_steps = 0

    def enqueue(self, handle: RequestHandle, cost: float = 1.0):
        handle.status = QUEUED
        self._queue.append((handle, max(float(cost), MIN_COST)))

    def requeue_front(self, handle: RequestHandle, cost: float = 1.0):
        """Put a PREEMPTED request back at the head of the queue (it was
        admitted first; preemption by page pressure must not also cost it
        its FIFO position)."""
        handle.status = QUEUED
        handle.slot = None
        self._queue.appendleft((handle, max(float(cost), MIN_COST)))

    def drop_queued(self, handle: RequestHandle) -> bool:
        """Remove a still-queued handle; True if it was found."""
        for i, (h, _) in enumerate(self._queue):
            if h is handle:
                del self._queue[i]
                return True
        return False

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def used_cost(self) -> float:
        return sum(c for s, c in zip(self.slots, self.costs) if s is not None)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    # ---- the replica axis (one replica) ----
    @property
    def slots_per_replica(self) -> int:
        return self.n_slots

    def replica_of(self, slot: int) -> int:
        return slot // self.slots_per_replica

    def free_slots_in(self, replica: int) -> List[int]:
        return self.free_slots() if replica == 0 else []

    def admit(self, page_check=None) -> List[Tuple[int, RequestHandle]]:
        """Pop queued requests into free slots under the FLOP budget;
        returns [(slot, handle)] for the engine to prefill.
        ``page_check(handle, replica) -> bool`` (optional) is the paged
        engine's joint-packing hook: the head is admitted only when the
        replica also has the free KV pages its prompt needs. A head that
        cannot get its pages waits, and nothing jumps it."""
        out: List[Tuple[int, RequestHandle]] = []
        used = self.used_cost
        while self._queue:
            free = self.free_slots()
            if not free:
                break
            handle, cost = self._queue[0]
            if page_check is not None and not page_check(handle, 0):
                break                       # wait for page frees
            if used + cost > self.flop_budget + 1e-9 and self.active:
                break                       # wait for running work to drain
            self._queue.popleft()
            slot = free[0]
            self.slots[slot], self.costs[slot] = handle, cost
            handle.slot, handle.status = slot, RUNNING
            used += cost
            out.append((slot, handle))
        return out

    def free(self, slot: int) -> None:
        self.slots[slot] = None
        self.costs[slot] = 0.0

    def tick(self):
        """Record one engine step for occupancy accounting."""
        self.steps += 1
        self.active_slot_steps += self.active

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots active per engine step so far."""
        if self.steps == 0:
            return 0.0
        return self.active_slot_steps / (self.steps * self.n_slots)
