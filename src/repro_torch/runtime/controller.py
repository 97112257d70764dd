"""SLO-driven graceful degradation: the feedback loop on the budget knob.

ElastiFormer makes compute a runtime knob (an ``ElasticPolicy`` row per
request, spliced into the serving engine's live policy leaves);
everything up to here sets that knob by hand via ``--budget``.
``SLOController`` closes the loop: it watches per-replica latency
percentiles (time-to-first-token and inter-token latency, sourced from the
per-token timestamps on ``RequestHandle``) plus queue depth over a sliding
window, and when an SLO is threatened degrades service in stages — each
stage strictly cheaper than the next:

1. **Degrade admission budgets** — newly admitted requests get
   ``min(requested, admission_budget)``; the roofline solver turns that
   into a sparser policy row AND a smaller scheduler cost, so the same
   FLOP budget co-schedules more requests.
2. **Degrade the depth budget** — when the spec routes depth, the engine
   caps ``ElasticPolicy.depth_capacity`` at ``depth_budget`` for new AND
   in-flight rows (a tensor leaf the decode step reads: the same captured
   graphs, no new capture); whole-layer skips are the steepest
   FLOPs-per-quality knob after admission, and they compose
   multiplicatively with the token budget.
3. **Degrade in-flight budgets** — the engine splices degraded rows into
   the live ``(B,)`` policy in place (``ElasticPolicy.set_row_``, which a
   replayed decode graph reads: no new capture) and re-prices the slots'
   scheduler costs.
4. **Shed load** — queued requests beyond what a floor-budget engine can
   drain are finished with a typed ``rejected`` terminal state and a
   ``Retry-After`` hint; expired deadlines become ``deadline_exceeded``.
5. **Escalate** — if the controller saturates at the floor budget for
   ``escalate_after`` consecutive evaluations and load is still over,
   ``should_escalate`` goes high and the serving loop may
   ``engine.reshard()`` (``runtime/fault_tolerance.maybe_escalate``).

Restoration is **hysteretic**: budgets step back up only after the worst
violation ratio stays below ``hysteresis`` (< 1) for ``patience``
consecutive evaluations, in reverse stage order (in-flight, then depth,
then admission), so the controller cannot oscillate across the SLO
boundary.

Determinism contract: the controller NEVER reads a wall clock. Every
timestamp is injected — ``record_ttft`` / ``record_itl`` take measured
milliseconds, ``update(t, ...)`` takes the caller's clock — so a recorded
trace replays to a bit-identical budget trajectory.

This is the JAX package's ``runtime/controller.py``, copied so that the
port depends on nothing of that package (importing it would run its
package's ``__init__``, which imports JAX). It imports no array library.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

DEFAULT_CLASS = "default"

# Budgets move on a fixed lattice so the engine's solved-row cache stays
# bounded: every controller-chosen budget is a multiple of BUDGET_QUANTUM.
BUDGET_QUANTUM = 1.0 / 16.0


def _quantize(b: float) -> float:
    return max(BUDGET_QUANTUM, round(b / BUDGET_QUANTUM) * BUDGET_QUANTUM)


def _p95(xs) -> float:
    """Deterministic p95 (linear interpolation, no numpy RNG involved)."""
    s = sorted(xs)
    if not s:
        return 0.0
    k = 0.95 * (len(s) - 1)
    lo = int(math.floor(k))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


@dataclass(frozen=True)
class SLOTarget:
    """Per-tenant-class SLO: latency targets plus shed/deadline policy.

    ``math.inf`` targets are "don't care". ``shed_order`` breaks ties when
    the controller sheds: higher sheds first (batch traffic before
    interactive). ``deadline_ms`` is the default queue deadline applied to
    the class's requests at submit time (None = no deadline).
    """
    p95_ttft_ms: float = math.inf
    p95_itl_ms: float = math.inf
    shed_order: int = 0
    deadline_ms: Optional[float] = None


@dataclass
class SLOController:
    """Staged degrade/restore feedback controller over the elastic budget.

    All tunables are constructor fields; all state is explicit so tests
    can snapshot it. ``trajectory`` accumulates one row per evaluation —
    ``(t, ratio, admission, depth, inflight, shed, escalate)`` — and is
    the bit-reproducibility surface for the determinism test.
    """
    targets: Dict[str, SLOTarget] = field(
        default_factory=lambda: {DEFAULT_CLASS: SLOTarget()})
    floor: float = 0.25              # lowest budget any stage may impose
    step_down: float = 0.25          # degrade step per violating eval
    step_up: float = 0.125           # hysteretic restore step
    window: int = 64                 # sliding-window samples per metric
    min_samples: int = 4             # ignore windows thinner than this
    eval_interval_s: float = 0.25    # min injected-time between evals
    hysteresis: float = 0.7          # restore only while ratio < this
    patience: int = 3                # healthy evals required per restore
    queue_factor: float = 1.0        # healthy backlog = factor * capacity
    escalate_after: int = 4          # saturated evals before remesh ask
    retry_after_s: float = 1.0       # base Retry-After hint for shed
    sample_ttl_s: float = 10.0       # latency samples expire after this

    # ---- state (all deterministic; no wall-clock reads anywhere) ----
    admission_budget: float = 1.0
    depth_budget: float = 1.0
    inflight_budget: float = 1.0
    trajectory: List[Tuple[float, float, float, float, float, int,
                           bool]] = field(default_factory=list)
    events: List[Tuple[float, str, float]] = field(default_factory=list)
    shed_total: int = 0

    def __post_init__(self):
        if not (0.0 < self.floor <= 1.0):
            raise ValueError(f"floor must be in (0, 1], got {self.floor}")
        self.floor = _quantize(self.floor)
        self._ttft: Dict[Tuple[str, int], Deque[float]] = {}
        self._itl: Dict[Tuple[str, int], Deque[float]] = {}
        self._last_eval: Optional[float] = None
        self._healthy = 0
        self._saturated = 0
        self._escalate_pending = False

    # ---- metric ingestion (engine hooks) ----
    def target_for(self, slo_class: str) -> SLOTarget:
        return self.targets.get(slo_class,
                                self.targets.get(DEFAULT_CLASS, SLOTarget()))

    def _window(self, store, slo_class: str, replica: int) -> Deque[float]:
        key = (slo_class, replica)
        w = store.get(key)
        if w is None:
            w = store[key] = deque(maxlen=self.window)
        return w

    def record_ttft(self, slo_class: str, replica: int, ms: float,
                    t: float = 0.0) -> None:
        """Admission-time hook: queue wait + prefill, in milliseconds.
        ``t`` is the sample's (injected) timestamp — samples older than
        ``sample_ttl_s`` at evaluation time are expired, so a quiet period
        cannot pin the controller to stale overload percentiles forever."""
        self._window(self._ttft, slo_class, replica).append(
            (float(t), float(ms)))

    def record_itl(self, slo_class: str, replica: int, ms: float,
                   t: float = 0.0) -> None:
        """Decode-step hook: gap between consecutive tokens of one slot."""
        self._window(self._itl, slo_class, replica).append(
            (float(t), float(ms)))

    def _expire_samples(self, t: float) -> None:
        horizon = t - self.sample_ttl_s
        for store in (self._ttft, self._itl):
            for w in store.values():
                while w and w[0][0] < horizon:
                    w.popleft()

    # ---- observability ----
    def pressure(self, queue_depth: int = 0, capacity: int = 1) -> float:
        """Worst violation ratio: max over (class, replica) windows of
        observed-p95 / target, plus the queue-backlog ratio. > 1 means an
        SLO is threatened; < ``hysteresis`` means comfortably healthy."""
        ratio = 0.0
        for store, attr in ((self._ttft, "p95_ttft_ms"),
                            (self._itl, "p95_itl_ms")):
            for (cls, _rep), w in store.items():
                if len(w) < self.min_samples:
                    continue
                tgt = getattr(self.target_for(cls), attr)
                if math.isfinite(tgt) and tgt > 0:
                    ratio = max(ratio, _p95([ms for _t, ms in w]) / tgt)
        if capacity > 0:
            ratio = max(ratio,
                        queue_depth / (self.queue_factor * capacity))
        return ratio

    @property
    def should_escalate(self) -> bool:
        """True once the controller has saturated at the floor budget for
        ``escalate_after`` evals with load still over — the serving loop
        should ``engine.reshard()`` to a bigger shape and then call
        ``notify_remeshed()``."""
        return self._escalate_pending

    def notify_remeshed(self) -> None:
        """The serving loop handled (or declined) the escalation; rearm."""
        self._escalate_pending = False
        self._saturated = 0

    def retry_after(self, ratio: float) -> float:
        """Retry-After hint (seconds) scaled by how far over SLO we are."""
        return round(self.retry_after_s * max(1.0, ratio), 3)

    def admission_cap(self) -> Optional[float]:
        """Budget cap for NEW admissions; None when not degraded."""
        return None if self.admission_budget >= 1.0 else self.admission_budget

    def depth_cap(self) -> Optional[float]:
        """Cap on ``ElasticPolicy.depth_capacity`` for all rows (new and
        in-flight); None when not degraded. Engines whose spec does not
        route depth ignore it — the ladder then behaves as if the stage
        were absent except for the extra evaluations it absorbs."""
        return None if self.depth_budget >= 1.0 else self.depth_budget

    # ---- the control step ----
    def update(self, t: float, *, queue_depth: int,
               capacity: int) -> Dict[str, object]:
        """One control evaluation at injected time ``t`` (seconds, any
        monotone origin). Rate-limited to ``eval_interval_s``. Returns
        ``{"evaluated", "ratio", "shed", "escalate"}`` — ``shed`` is how
        many queued requests the caller should reject now, ``escalate``
        is the saturation->remesh edge (also latched on
        ``should_escalate``)."""
        out = {"evaluated": False, "ratio": 0.0, "shed": 0,
               "escalate": False}
        if (self._last_eval is not None
                and t - self._last_eval < self.eval_interval_s):
            return out
        self._last_eval = t
        self._expire_samples(t)
        ratio = self.pressure(queue_depth=queue_depth, capacity=capacity)
        out["evaluated"] = True
        out["ratio"] = ratio
        shed = 0
        escalate = False
        eps = 1e-9
        if ratio > 1.0 + eps:
            self._healthy = 0
            if self.admission_budget > self.floor + eps:
                self.admission_budget = _quantize(
                    max(self.floor, self.admission_budget - self.step_down))
                self.events.append((t, "degrade_admission",
                                    self.admission_budget))
            elif self.depth_budget > self.floor + eps:
                self.depth_budget = _quantize(
                    max(self.floor, self.depth_budget - self.step_down))
                self.events.append((t, "degrade_depth", self.depth_budget))
            elif self.inflight_budget > self.floor + eps:
                self.inflight_budget = _quantize(
                    max(self.floor, self.inflight_budget - self.step_down))
                self.events.append((t, "degrade_inflight",
                                    self.inflight_budget))
            else:
                # saturated at the floor: shed what a floor-budget engine
                # cannot drain, and count down to escalation
                self._saturated += 1
                keep = int(math.ceil(self.queue_factor * capacity))
                shed = max(0, int(queue_depth) - keep)
                if shed:
                    self.shed_total += shed
                    self.events.append((t, "shed", float(shed)))
                if (self._saturated >= self.escalate_after
                        and not self._escalate_pending):
                    self._escalate_pending = True
                    escalate = True
                    self.events.append((t, "escalate", 0.0))
        else:
            self._saturated = 0
            if ratio < self.hysteresis:
                self._healthy += 1
                if (self._healthy >= self.patience
                        and (self.admission_budget < 1.0 - eps
                             or self.depth_budget < 1.0 - eps
                             or self.inflight_budget < 1.0 - eps)):
                    # restore in reverse stage order: in-flight, depth,
                    # then admission
                    if self.inflight_budget < 1.0 - eps:
                        self.inflight_budget = _quantize(min(
                            1.0, self.inflight_budget + self.step_up))
                        self.events.append((t, "restore_inflight",
                                            self.inflight_budget))
                    elif self.depth_budget < 1.0 - eps:
                        self.depth_budget = _quantize(min(
                            1.0, self.depth_budget + self.step_up))
                        self.events.append((t, "restore_depth",
                                            self.depth_budget))
                    else:
                        self.admission_budget = _quantize(min(
                            1.0, self.admission_budget + self.step_up))
                        self.events.append((t, "restore_admission",
                                            self.admission_budget))
                    self._healthy = 0
            else:
                self._healthy = 0   # inside the hysteresis band: hold
        out["shed"] = shed
        out["escalate"] = escalate
        self.trajectory.append((t, ratio, self.admission_budget,
                                self.depth_budget, self.inflight_budget,
                                shed, escalate))
        return out

    def summary(self) -> Dict[str, object]:
        """Counters for reports: events by kind + final budgets."""
        kinds: Dict[str, int] = {}
        for _t, kind, _v in self.events:
            kinds[kind] = kinds.get(kind, 0) + 1
        return {"admission_budget": self.admission_budget,
                "depth_budget": self.depth_budget,
                "inflight_budget": self.inflight_budget,
                "shed_total": self.shed_total,
                "evals": len(self.trajectory),
                "events": kinds}
