"""Trace-driven serving workloads: arrival processes, request mixes, replay.

The serving benchmarks and the fault drills drive the engine through this
one harness:

* **Arrival processes** — homogeneous Poisson, bursty (a mid-run rate
  spike: the overload the SLO controller exists for), and diurnal
  (sinusoidal rate via Poisson thinning — the slow load swing that
  exercises hysteretic restore).
* **Request mixes** — heavy-tailed (lognormal) prompt/output lengths and
  mixed tenants with per-tenant SLO classes (``GenRequest.slo_class``).
* **replay()** — the open-loop driver: submits on the arrival schedule,
  steps the engine, and survives faults mid-trace — replica failure via
  ``FailureInjector`` -> drain + re-mesh onto a fallback shape, straggler
  injection against the ``StragglerWatchdog``, and controller-saturation
  escalation (``maybe_escalate``). On the wall clock by default; on a
  ``StepClock`` (the engine's injected clock, advanced a fixed tick per
  step) the same trace gives the same schedule, run after run.
* **summarize()** — per-class latency percentiles, SLO attainment
  (a served request meets SLO when its own TTFT is within its class
  target; shed/expired requests are misses), and **goodput**: SLO-met
  tokens/sec weighted by the budget they were served at, so a
  budget-0.25 token counts as a quarter of a full-compute token.
* **latency_stats()** — the latency columns of a set of handles.

This is the JAX package's ``benchmarks/workloads.py`` (with
``latency_stats`` from its ``launch/serve.py``) on the port's
``GenRequest`` and fault tolerance, copied so that the port depends on
nothing of that package; ``StepClock`` and ``replay``'s ``clock`` are the
port's.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------- arrival processes ------------------------------

def poisson_times(rng: np.random.Generator, rate: float,
                  n: int) -> np.ndarray:
    """Homogeneous Poisson arrivals: n cumulative times at ``rate`` req/s."""
    return np.cumsum(rng.exponential(1.0 / rate, n))


def piecewise_poisson(rng: np.random.Generator,
                      segments: Sequence[Tuple[float, int]]) -> np.ndarray:
    """Concatenated Poisson segments: [(rate, n), ...] -> sorted times."""
    out, t = [], 0.0
    for rate, n in segments:
        gaps = rng.exponential(1.0 / rate, n)
        ts = t + np.cumsum(gaps)
        out.append(ts)
        if n:
            t = float(ts[-1])
    return np.concatenate(out) if out else np.zeros(0)


def bursty_times(rng: np.random.Generator, rate: float, n: int,
                 burst_factor: float = 4.0,
                 burst_frac: float = 0.4) -> np.ndarray:
    """Pre / burst / post: the middle ``burst_frac`` of requests arrive at
    ``burst_factor`` x the base rate — the overload transient."""
    n_burst = int(round(n * burst_frac))
    n_pre = (n - n_burst) // 2
    n_post = n - n_burst - n_pre
    return piecewise_poisson(rng, [(rate, n_pre),
                                   (rate * burst_factor, n_burst),
                                   (rate, n_post)])


def diurnal_times(rng: np.random.Generator, rate: float, n: int,
                  period_s: Optional[float] = None,
                  swing: float = 0.8) -> np.ndarray:
    """Sinusoidal-rate Poisson via thinning: rate(t) = rate * (1 + swing *
    sin(2 pi t / period)). Default period puts ~2 cycles in the run."""
    if period_s is None:
        period_s = max(1e-6, n / (2.0 * rate))
    rmax = rate * (1.0 + swing)
    out, t = [], 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / rmax))
        lam = rate * (1.0 + swing * math.sin(2 * math.pi * t / period_s))
        if rng.uniform() * rmax <= lam:
            out.append(t)
    return np.asarray(out)


def arrival_times(kind: str, rate: float, n: int,
                  seed: int = 0) -> np.ndarray:
    """Dispatch by trace kind: poisson | bursty | diurnal."""
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        return poisson_times(rng, rate, n)
    if kind == "bursty":
        return bursty_times(rng, rate, n)
    if kind == "diurnal":
        return diurnal_times(rng, rate, n)
    raise ValueError(f"unknown trace kind {kind!r}")


# ------------------------------- request mixes --------------------------------

def heavy_tailed_lengths(rng: np.random.Generator, n: int, lo: int, hi: int,
                         median: Optional[float] = None,
                         sigma: float = 0.6) -> np.ndarray:
    """Lognormal lengths clipped to [lo, hi] — most requests short, a heavy
    tail of long ones (the production prompt/output length shape)."""
    if median is None:
        median = math.sqrt(lo * hi)
    x = rng.lognormal(math.log(median), sigma, n)
    return np.clip(np.round(x), lo, hi).astype(int)


def make_requests(n: int, vocab: int, *,
                  prompt_lo: int = 4, prompt_hi: int = 64,
                  max_new_lo: int = 4, max_new_hi: int = 32,
                  class_mix: Optional[Dict[str, float]] = None,
                  budget: Optional[float] = None,
                  seed: int = 0) -> list:
    """Build n GenRequests with heavy-tailed prompt/output lengths and a
    weighted tenant-class mix (``class_mix`` name -> weight)."""
    from repro_torch.training import GenRequest
    rng = np.random.default_rng(seed)
    plens = heavy_tailed_lengths(rng, n, prompt_lo, prompt_hi)
    nnews = heavy_tailed_lengths(rng, n, max_new_lo, max_new_hi)
    if class_mix:
        names = sorted(class_mix)
        w = np.asarray([class_mix[k] for k in names], float)
        classes = rng.choice(names, n, p=w / w.sum())
    else:
        classes = ["default"] * n
    return [GenRequest(rng.integers(0, vocab, int(plens[i]), dtype=np.int32),
                       int(nnews[i]), budget=budget, seed=i,
                       slo_class=str(classes[i]))
            for i in range(n)]


# ---------------------------------- replay ------------------------------------

class StepClock:
    """A clock that moves only when told to: ``clock()`` is the time ``t``,
    ``tick()`` moves it on by ``tick_s`` (> 0). Given to an engine
    (``clock=``) and to ``replay`` (``clock=``, which ticks it once per
    loop iteration), it makes every request timestamp, deadline and
    controller evaluation a function of the step count."""

    def __init__(self, tick_s: float, t: float = 0.0):
        if not tick_s > 0:
            raise ValueError(f"a StepClock needs tick_s > 0, got {tick_s}")
        self.tick_s = float(tick_s)
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.tick_s


def replay(engine, reqs: list, arrive: np.ndarray, *,
           fallback_shapes: Sequence[tuple] = (),
           injector=None, watchdog=None,
           straggle_at: Sequence[int] = (), straggle_s: float = 0.0,
           clock: Optional[StepClock] = None,
           remesh_at: Optional[int] = None, remesh_to=None):
    """Open-loop trace replay with fault drills: submit each request at its
    arrival time (handles' ``t_submit`` pinned to the schedule), step the
    engine continuously, and keep serving through injected faults —
    ``SimulatedFailure`` drains + re-meshes onto the next fallback shape
    (zero lost in-flight requests: their state is the slot caches, which
    ``reshard`` keeps), stragglers (``straggle_at`` steps sleep an extra
    ``straggle_s``) feed the watchdog, and controller saturation escalates
    through the SAME fallback-shape list.

    ``clock`` (optional): the ``StepClock`` the engine was built with. The
    schedule then runs on it instead of the wall clock: arrivals are
    compared with its time, it ticks once after every loop iteration, and
    nothing sleeps. The watchdog still times each step on
    the wall clock.

    A mesh engine (``engine.mesh``) runs the loop on every rank in
    lockstep: the count of arrivals due is taken on mesh rank 0's clock
    and broadcast each iteration (``collectives.broadcast_int``, which
    returns it as it is off a mesh). ``remesh_at=N``: after the N-th
    submission, re-mesh the live engine onto the (data, model) shape
    ``remesh_to`` (``launch.mesh.remesh``); in-flight requests keep
    their tokens. A rank that a re-mesh leaves out (``engine.left``)
    returns.

    Returns (handles, elapsed, info) — elapsed on the schedule's clock;
    info carries steps/restarts/escalations/queue_peak and ``remesh``:
    (submissions, seconds, requests in flight) of the ``remesh_at``
    re-mesh, or None."""
    from repro_torch.launch.mesh import remesh
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime.fault_tolerance import (SimulatedFailure,
                                                     maybe_escalate,
                                                     remesh_fallback)
    now_of = clock if clock is not None else time.perf_counter
    shapes = list(fallback_shapes)
    handles: List[object] = [None] * len(reqs)
    i = 0
    steps = restarts = escalations = 0
    queue_peak = 0
    remeshed = None
    straggle_at = set(straggle_at)
    t0 = now_of()
    while ((i < len(reqs) or engine.has_work)
           and not getattr(engine, "left", False)):
        due = C.broadcast_int(np.searchsorted(arrive, now_of() - t0,
                                              side="right"),
                              getattr(engine, "mesh", None))
        while i < min(due, len(reqs)):
            handles[i] = engine.submit(reqs[i])
            handles[i].t_submit = t0 + arrive[i]
            i += 1
        if remesh_at is not None and remeshed is None and i >= remesh_at:
            ts = time.perf_counter()
            engine.reshard(remesh(engine.mesh, remesh_to))
            remeshed = (i, time.perf_counter() - ts, engine.scheduler.active)
            if engine.left:
                break
        if maybe_escalate(engine, shapes):
            escalations += 1
        try:
            if injector is not None:
                injector.maybe_fail(steps)
            ts = time.perf_counter()
            if steps in straggle_at and straggle_s > 0:
                time.sleep(straggle_s)
            n = engine.step()
            if watchdog is not None:
                watchdog.observe(steps, time.perf_counter() - ts)
            steps += 1
        except SimulatedFailure:
            restarts += 1
            remesh_fallback(engine, shapes)
            n = 1
        queue_peak = max(queue_peak, engine.scheduler.pending)
        if clock is not None:
            clock.tick()
        elif n == 0 and i < len(reqs):
            wait = arrive[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    return handles, now_of() - t0, {
        "steps": steps, "restarts": restarts,
        "escalations": escalations, "queue_peak": queue_peak,
        "remesh": remeshed}


# --------------------------------- metrics ------------------------------------

def latency_stats(handles) -> dict:
    """Latency columns (milliseconds) over SERVED handles — rejected /
    deadline-expired requests are excluded (their "latency" is time to
    rejection, not service). Columns: end-to-end mean/p50/p95, TTFT
    (arrival -> first token: queue wait + prefill) p50/p95, and
    inter-token latency (decode-step gap) mean/p95 — all sourced from the
    per-token timestamps on ``RequestHandle``."""
    done = [h for h in handles
            if h is not None and h.latency is not None
            and h.status != "rejected"]
    lat = np.asarray([h.latency for h in done], float)
    ttft = np.asarray([h.ttft for h in done if h.ttft is not None], float)
    itl = np.asarray([g for h in done for g in h.inter_token()], float)
    pct = lambda a, q: float(np.percentile(a, q) * 1e3) if a.size else 0.0
    return {
        "mean_ms": float(lat.mean() * 1e3) if lat.size else 0.0,
        "p50_ms": pct(lat, 50),
        "p95_ms": pct(lat, 95),
        "ttft_p50_ms": pct(ttft, 50),
        "ttft_p95_ms": pct(ttft, 95),
        "itl_mean_ms": float(itl.mean() * 1e3) if itl.size else 0.0,
        "itl_p95_ms": pct(itl, 95),
    }


def summarize(handles: list, elapsed: float,
              targets: Optional[dict] = None) -> dict:
    """Trace-level serving metrics. A served request MEETS its SLO when
    its own TTFT is within its class's p95 target (per-request
    attainment); shed (``rejected``) and expired (``deadline_exceeded``)
    requests are attainment misses by definition. ``goodput_tok_s`` is
    SLO-met tokens/sec weighted by the budget each was served at
    (``RequestHandle.budget_served``) — degraded tokens count fractionally,
    so a controller cannot win the curve by degrading everything to the
    floor and calling it throughput."""
    hs = [h for h in handles if h is not None]
    served = [h for h in hs if h.status == "done"]
    shed = sum(h.finish_reason == "rejected" for h in hs)
    expired = sum(h.finish_reason == "deadline_exceeded" for h in hs)
    n_tok = sum(len(h.output) for h in served)

    def _target_ms(h) -> float:
        if not targets:
            return math.inf
        tgt = targets.get(h.tenant) or targets.get("default")
        return tgt.p95_ttft_ms if tgt is not None else math.inf

    met = [h for h in served
           if h.ttft is not None and h.ttft * 1e3 <= _target_ms(h)]
    goodput = sum(len(h.output) * float(getattr(h, "budget_served", 1.0))
                  for h in met)
    out = {
        "n": len(hs), "served": len(served), "shed": int(shed),
        "expired": int(expired), "n_tokens": int(n_tok),
        "elapsed_s": float(elapsed),
        "tok_s": n_tok / elapsed if elapsed > 0 else 0.0,
        "attainment": len(met) / len(hs) if hs else 0.0,
        "goodput_tok_s": goodput / elapsed if elapsed > 0 else 0.0,
    }
    out.update(latency_stats(served))
    classes = sorted({h.tenant for h in served})
    if len(classes) > 1:
        out["per_class"] = {
            c: latency_stats([h for h in served if h.tenant == c])
            for c in classes}
    return out
