"""Fault tolerance & straggler mitigation for the training AND serving loops.

Single-controller view of what runs per host at scale:
  * StragglerWatchdog — EWMA of step wall-times; a step exceeding
    `threshold x` the EWMA flags the slow host (here: logs + counter; on a
    real fleet this feeds the re-dispatch / hot-spare controller).
  * run_resilient — training supervision loop: on any step failure it
    restores the latest verified checkpoint (params/opt/data state) and
    replays from there. Deterministic data (pipeline.batch_at(step)) makes
    the replay bitwise-reproducible.
  * serve_resilient — the serving twin: on a step failure the ServingEngine
    drains and re-meshes onto a fallback (data, model) shape instead of
    killing the server — in-flight requests live in the slot caches, which
    `engine.reshard` keeps, so they resume with identical tokens.
  * FailureInjector — deterministic fault injection for tests/drills.

This is the JAX package's ``runtime/fault_tolerance.py``, copied so that
the port depends on nothing of that package. A fallback shape is a
``(data, model)`` tuple (``runtime/elastic.valid_mesh_shapes`` lists the
real ones): a mesh engine re-meshes onto it over its own process world
(``launch.mesh.remesh``, every rank in lockstep), a shape of one device or
the exhausted list re-meshes with ``engine.reshard(None)``, and a shape
the engine cannot take (more ranks than its world, a batch its data axis
does not divide, a one-device engine without a world) is skipped like any
unusable shape.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("repro_torch.ft")


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise SimulatedFailure at the given steps (once each)."""
    at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class StragglerWatchdog:
    threshold: float = 2.5
    decay: float = 0.9
    ewma: Optional[float] = None
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs) — "
                        "flagging for re-dispatch", step, dt, self.ewma)
            # A flagged sample is EXCLUDED from the baseline: folding a
            # straggler's dt in would inflate the baseline by up to
            # `decay + (1-decay)*threshold` per flagged step, so a
            # sustained slowdown would stop being flagged after a few
            # steps. The EWMA tracks what a HEALTHY step costs.
        else:
            self.ewma = dt if self.ewma is None else \
                self.decay * self.ewma + (1 - self.decay) * dt
        return slow


def run_resilient(
    *, start_step: int, total_steps: int,
    do_step: Callable[[int], dict],
    save: Callable[[int], None], restore: Callable[[], int],
    save_every: int = 50, max_restarts: int = 10,
    injector: Optional[FailureInjector] = None,
    watchdog: Optional[StragglerWatchdog] = None,
):
    """Supervised training loop. `do_step(step)` runs one step and returns
    metrics; `save(step)` checkpoints; `restore()` reloads the latest
    checkpoint and returns its step. Returns (last_metrics, n_restarts)."""
    step = start_step
    restarts = 0
    metrics = {}
    while step < total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            metrics = do_step(step)
            if watchdog is not None:
                watchdog.observe(step, time.perf_counter() - t0)
            step += 1
            if step % save_every == 0 or step == total_steps:
                save(step)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("step %d failed (%s); restoring latest checkpoint",
                        step, e)
            step = restore()
    return metrics, restarts


def remesh_fallback(engine, shapes: list):
    """Drain + re-mesh ``engine`` onto the first usable shape popped from
    ``shapes`` (mutated in place). An unusable shape (more ranks than the
    engine's process world, a batch its data axis does not divide, no
    world at all) is skipped rather than allowed to kill the server — the
    exhausted list still ends at the single-device fallback (``None``).
    Returns the mesh re-meshed to (``None`` for one device). Raises only
    when even the single-device fallback fails."""
    from repro_torch.launch.mesh import remesh
    while True:
        shape = shapes.pop(0) if shapes else None
        try:
            mesh = (remesh(engine.mesh, shape)
                    if shape is not None and math.prod(shape) > 1
                    else None)
            engine.reshard(mesh)
        except Exception as fe:
            if shape is None:         # even 1 device failed: give up
                raise
            log.warning("fallback shape %s unusable (%s); trying "
                        "the next", shape, fe)
            continue
        return mesh


def maybe_escalate(engine, shapes: list) -> bool:
    """SLO-controller saturation -> re-mesh escalation: when the engine's
    controller has been pinned at the floor budget past its patience
    (``should_escalate``), drain + re-mesh onto the next fallback shape.
    Consumes the escalation either way (a declined escalation — no shapes
    left, or a paged engine that cannot reshard — must not re-fire every
    step). Returns True if a re-mesh happened."""
    ctrl = getattr(engine, "controller", None)
    if ctrl is None or not getattr(ctrl, "should_escalate", False):
        return False
    if not shapes or getattr(engine, "kv_layout", "ring") != "ring":
        log.warning("controller escalation declined: %s",
                    "no fallback shapes left" if not shapes
                    else "paged engine cannot reshard live")
        ctrl.notify_remeshed()
        return False
    mesh = remesh_fallback(engine, shapes)
    log.warning("controller saturated at floor budget; escalated to %s",
                "1 device" if mesh is None else dict(mesh.shape))
    ctrl.notify_remeshed()
    return True


def serve_resilient(
    engine, *,
    fallback_shapes=(), max_restarts: int = 3,
    injector: Optional[FailureInjector] = None,
    watchdog: Optional[StragglerWatchdog] = None,
):
    """Drive ``engine.step()`` until idle, surviving replica failures.

    On a step failure (``SimulatedFailure`` from the injector — the stand-in
    for a lost replica/host) the engine drains and re-meshes onto the next
    entry of ``fallback_shapes`` (``(data, model)`` tuples; an exhausted
    list falls back to a single device) instead of the failure killing the
    server. In-flight requests are NOT dropped: their state is the slot
    caches, which ``engine.reshard`` keeps, so every running request
    resumes with identical (bitwise, greedy) tokens.

    If the engine carries an ``SLOController`` that saturates at the floor
    budget (``should_escalate``), the SAME fallback-shape path runs as a
    proactive escalation (``maybe_escalate``).

    Returns ``(n_steps, n_restarts)``."""
    shapes = list(fallback_shapes)
    steps = restarts = 0
    while engine.has_work:
        try:
            maybe_escalate(engine, shapes)
            if injector is not None:
                injector.maybe_fail(steps)
            t0 = time.perf_counter()
            engine.step()
            if watchdog is not None:
                watchdog.observe(steps, time.perf_counter() - t0)
            steps += 1
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            mesh = remesh_fallback(engine, shapes)
            log.warning("serving step %d failed (%s); drained + "
                        "re-meshed to %s", steps, e,
                        "1 device" if mesh is None else dict(mesh.shape))
    return steps, restarts
