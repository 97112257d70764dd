"""Request lifecycle + slot scheduler for continuous-batching serving.

The serving engine owns a FIXED array of B decode slots (one decode step
over all of them, finished/empty slots masked). This module owns the
host-side bookkeeping around that array:

* ``RequestHandle`` — the lifecycle object ``engine.submit`` returns:
  QUEUED -> RUNNING -> DONE | CANCELLED | REJECTED, a streaming
  ``tokens()`` iterator, and per-token latency timestamps read from an
  injected clock (TTFT and inter-token gaps feed the SLO controller, see
  ``runtime/controller.py``).

* ``SlotScheduler`` — admission of queued requests into free slots, packed
  against a per-step FLOP budget: each request costs its compute budget
  (the roofline active-FLOP fraction its ``ElasticPolicy`` was solved for;
  1.0 = full teacher row), and a request is admitted while the occupied
  cost sum stays within ``flop_budget``. Low-budget requests therefore
  co-schedule more densely. Requests queue per tenant class (FIFO within a
  class, earliest arrival across classes, so a single class is one global
  FIFO), carry optional queue deadlines (expired entries are dropped
  before they burn a prefill, finish reason ``deadline_exceeded``), and
  can be shed under overload (finish reason ``rejected`` + a Retry-After
  hint on the handle). ``flop_budget=None`` means "one full-budget row per
  slot" (admission limited only by free slots).

This is the single-replica form of the JAX package's
``runtime/scheduler.py`` (the same admission order, packing, deadlines,
shedding and repricing, the paged engine's ``page_check`` and
``requeue_front`` included), copied so that the port depends on nothing
of that package. The replica helpers (``replica_of``, ``free_slots_in``)
exist for the engine's calls; the replica axis of SPMD serving arrives
with the mesh slice (ROADMAP Queue A item 11). The scheduler imports no
array library; the engine calls ``admit()`` / ``free()`` / ``tick()``
around its steps.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
REJECTED = "rejected"

# Terminal finish reasons that map to the REJECTED status: the server
# declined to serve the request (shed under overload, or its queue deadline
# passed before admission), typed so clients can tell "retry later" from a
# served completion.
_REJECT_REASONS = ("rejected", "deadline_exceeded")

# Admission-cost floor: a request whose roofline budget fraction rounds to
# ~0 FLOPs still occupies a decode-slot lane, so its scheduling cost can
# never be 0 — otherwise zero-cost rows bypass the FLOP budget entirely.
MIN_COST = 2.0 ** -10

DEFAULT_TENANT = "default"


class RequestHandle:
    """Lifecycle handle for one submitted request.

    ``tokens()`` is a pull-based stream: it yields tokens already produced
    and, while the request is live, drives ``engine.step()`` to produce
    more. ``done`` is True once the request reached any terminal state;
    ``output`` is the generated tokens so far (a list of ints).

    Timestamps come from the injected ``clock`` (default
    ``time.perf_counter``), so tests and the SLO controller can drive a
    fully deterministic clock: ``t_submit``, ``t_first``, per-token
    ``t_tokens``, ``t_done``. ``deadline`` (absolute, same clock) expires
    the request while queued; ``retry_after`` is the server's hint
    (seconds) when the request was shed.
    """

    _ids = itertools.count()

    def __init__(self, request, engine=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.id = next(self._ids)
        self.request = request
        self.status = QUEUED
        self.slot: Optional[int] = None
        self.output: List[int] = []
        # length | eos | cancelled | rejected | deadline_exceeded
        self.finish_reason: Optional[str] = None
        self._clock = clock
        self.t_submit = clock()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.t_tokens: List[float] = []
        self.tenant: str = DEFAULT_TENANT
        self.deadline: Optional[float] = None
        self.retry_after: Optional[float] = None
        self.budget_served: float = 1.0
        self._engine = engine

    @property
    def done(self) -> bool:
        return self.status in (DONE, CANCELLED, REJECTED)

    @property
    def latency(self) -> Optional[float]:
        """Submit -> finish time in seconds (None while live)."""
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first token in seconds (queue wait + prefill)."""
        return None if self.t_first is None else self.t_first - self.t_submit

    def inter_token(self) -> List[float]:
        """Gaps between consecutive token timestamps, seconds."""
        return [b - a for a, b in zip(self.t_tokens, self.t_tokens[1:])]

    def append(self, tok: int):
        t = self._clock()
        if self.t_first is None:
            self.t_first = t
        self.t_tokens.append(t)
        self.output.append(tok)

    def finish(self, reason: str):
        if reason == "cancelled":
            self.status = CANCELLED
        elif reason in _REJECT_REASONS:
            self.status = REJECTED
        else:
            self.status = DONE
        self.finish_reason = reason
        self.t_done = self._clock()

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


class _QEntry:
    """One queued request. ``dropped`` tombstones the entry in place so
    ``drop_queued`` is O(1) (keyed by handle id); tombstones are swept
    lazily at queue heads and filtered from every view."""

    __slots__ = ("handle", "cost", "seq", "dropped")

    def __init__(self, handle: RequestHandle, cost: float, seq: int):
        self.handle = handle
        self.cost = cost
        self.seq = seq
        self.dropped = False


class SlotScheduler:
    """Admission into a fixed slot array under a per-step FLOP budget.

    ``cost`` of a request = its compute-budget fraction (1.0 for
    budget-None / teacher rows). Requests queue FIFO **within** their
    tenant class and the earliest-arrival live head **across** classes goes
    first. A head that cannot be placed (FLOP budget, or the paged
    engine's ``page_check``) blocks only its own class — another class's
    head may still fit — but within a class nothing jumps the queue. A
    request is placed in the lowest free slot while the occupied cost sum
    stays within ``flop_budget``; if nothing is running and the oldest head
    alone exceeds the budget it is admitted anyway (progress guarantee).
    """

    def __init__(self, n_slots: int, flop_budget: Optional[float] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.flop_budget = (float(n_slots) if flop_budget is None
                            else float(flop_budget))
        self.slots: List[Optional[RequestHandle]] = [None] * n_slots
        self.costs: List[float] = [0.0] * n_slots
        self._queues: Dict[str, Deque[_QEntry]] = {}
        self._by_id: Dict[int, _QEntry] = {}
        self._n_pending = 0
        self._seq = itertools.count()
        self._front_seq = -1            # requeue_front goes before seq 0
        # occupancy accounting (slot-steps used / slot-steps available)
        self.steps = 0
        self.active_slot_steps = 0

    # ---- the replica axis (one replica) ----
    @property
    def slots_per_replica(self) -> int:
        return self.n_slots

    def replica_of(self, slot: int) -> int:
        return slot // self.slots_per_replica

    def free_slots_in(self, replica: int) -> List[int]:
        return self.free_slots() if replica == 0 else []

    # ---- queue ----
    @property
    def queue(self) -> List[Tuple[RequestHandle, float]]:
        """Arrival-ordered view of live queued entries as (handle, cost)."""
        live = [e for q in self._queues.values() for e in q if not e.dropped]
        live.sort(key=lambda e: e.seq)
        return [(e.handle, e.cost) for e in live]

    def _push(self, entry: _QEntry, front: bool) -> None:
        q = self._queues.setdefault(entry.handle.tenant, deque())
        (q.appendleft if front else q.append)(entry)
        self._by_id[entry.handle.id] = entry
        self._n_pending += 1

    def _remove(self, entry: _QEntry) -> None:
        entry.dropped = True
        self._by_id.pop(entry.handle.id, None)
        self._n_pending -= 1

    def enqueue(self, handle: RequestHandle, cost: float = 1.0):
        handle.status = QUEUED
        self._push(_QEntry(handle, max(float(cost), MIN_COST),
                           next(self._seq)), front=False)

    def requeue_front(self, handle: RequestHandle, cost: float = 1.0):
        """Put a PREEMPTED request back at the head of the queue (it was
        admitted first; preemption by page pressure must not also cost it
        its FIFO position)."""
        handle.status = QUEUED
        handle.slot = None
        entry = _QEntry(handle, max(float(cost), MIN_COST), self._front_seq)
        self._front_seq -= 1
        self._push(entry, front=True)

    def drop_queued(self, handle: RequestHandle) -> bool:
        """Remove a still-queued handle; True if it was found. O(1): the
        entry is tombstoned in place and swept when it reaches a queue
        head."""
        entry = self._by_id.get(handle.id)
        if entry is None or entry.dropped:
            return False
        self._remove(entry)
        return True

    def expire_deadlines(self, now: float) -> List[RequestHandle]:
        """Drop every queued handle whose deadline has passed — BEFORE it
        is admitted and burns a prefill. Expired handles are finished with
        reason ``deadline_exceeded`` and returned."""
        out: List[RequestHandle] = []
        for q in self._queues.values():
            for entry in q:
                if entry.dropped:
                    continue
                dl = entry.handle.deadline
                if dl is not None and now >= dl:
                    self._remove(entry)
                    entry.handle.finish("deadline_exceeded")
                    out.append(entry.handle)
        return out

    def shed(self, n: int, priority=None) -> List[RequestHandle]:
        """Reject ``n`` queued requests (overload). Victims are picked
        newest-first within the most sheddable class first
        (``priority(handle)``: higher sheds first; default: arrival order
        only), finished with reason ``rejected``, and returned so the
        caller can attach Retry-After hints."""
        live = [e for q in self._queues.values() for e in q if not e.dropped]
        live.sort(key=lambda e: ((-priority(e.handle) if priority else 0),
                                 -e.seq))
        out: List[RequestHandle] = []
        for entry in live[:max(0, int(n))]:
            self._remove(entry)
            entry.handle.finish("rejected")
            out.append(entry.handle)
        return out

    # ---- slots ----
    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return self._n_pending

    @property
    def used_cost(self) -> float:
        return sum(c for s, c in zip(self.slots, self.costs) if s is not None)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _live_heads(self) -> List[_QEntry]:
        """Sweep tombstones off every class head; return the live heads in
        arrival order (earliest seq first)."""
        heads: List[_QEntry] = []
        for q in self._queues.values():
            while q and q[0].dropped:
                q.popleft()
            if q:
                heads.append(q[0])
        heads.sort(key=lambda e: e.seq)
        return heads

    def admit(self, page_check=None, cost_cap: Optional[float] = None,
              cost_scale: Optional[float] = None
              ) -> List[Tuple[int, RequestHandle]]:
        """Pop queued requests into free slots under the FLOP budget;
        returns [(slot, handle)] for the engine to prefill.

        ``page_check(handle, replica) -> bool`` (optional) is the paged
        engine's joint-packing hook: a head is admitted only when the pool
        also has the free KV pages its prompt needs. A head that cannot get
        its pages waits, and nothing of its class jumps it.

        ``cost_cap`` (optional) is the SLO controller's degraded admission
        budget: each admission is charged ``min(cost, cost_cap)``, the price
        of the degraded policy row the engine will solve for it.

        ``cost_scale`` (optional) is the controller's depth cap: depth
        routing skips whole layers, so a request's FLOP cost is its budget
        fraction TIMES the depth fraction; admission packs on that composed
        cost, what the engine reprices the slot to after the prefill."""
        out: List[Tuple[int, RequestHandle]] = []
        used = self.used_cost
        while True:
            heads = self._live_heads()
            free = self.free_slots()
            if not heads or not free:
                break
            placed = False
            for k, entry in enumerate(heads):
                cost = entry.cost
                if cost_cap is not None:
                    cost = max(MIN_COST, min(cost, float(cost_cap)))
                if cost_scale is not None:
                    cost = max(MIN_COST, cost * float(cost_scale))
                if page_check is not None and not page_check(entry.handle, 0):
                    continue                # this class waits for page frees
                if used + cost > self.flop_budget + 1e-9 and not (
                        k == 0 and self.active == 0 and not out):
                    continue                # wait for running work to drain
                slot = free[0]
                self._remove(entry)
                self.slots[slot], self.costs[slot] = entry.handle, cost
                entry.handle.slot, entry.handle.status = slot, RUNNING
                used += cost
                out.append((slot, entry.handle))
                placed = True
                break
            if not placed:
                break
        return out

    def reprice(self, slot: int, cost: float) -> None:
        """Re-price a RUNNING slot's FLOP cost (in-flight degradation: the
        engine spliced a cheaper policy row into the slot, so the admission
        headroom grows to match)."""
        if self.slots[slot] is not None:
            self.costs[slot] = max(float(cost), MIN_COST)

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
