"""The port's host-side serving runtime against the JAX package's, without
an engine: the SLO controller, the scheduler's tenant classes, deadlines,
shedding and repricing, fault tolerance and the trace workloads.

Each case runs the same script through both packages' objects and holds
the results equal exactly (these modules compute in Python floats: no
tolerance):
  * ``SLOController`` on tests/test_controller.py's recorded trace and on
    its ladder, hysteresis, lattice, retry-after and rate-limit cases
    (:45-142): identical ``trajectory``, ``events``, ``shed_total`` and
    budgets, with the wall clock monkeypatched to raise;
  * ``SlotScheduler`` over random sequences of enqueues with tenants and
    deadlines, ``expire_deadlines``, ``shed(priority=)``, ``reprice``,
    ``admit(page_check=, cost_cap=, cost_scale=)``, ``drop_queued``,
    ``requeue_front`` and frees (extends tests/test_torch_serving.py's
    single-class case);
  * ``StragglerWatchdog``, ``FailureInjector`` and ``run_resilient`` on
    the same sequences;
  * the arrival processes, ``make_requests`` and ``summarize`` against
    benchmarks/workloads.py on the same numpy seeds.
"""
import math
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import benchmarks.workloads as JW  # noqa: E402
from repro.runtime import controller as JC  # noqa: E402
from repro.runtime import fault_tolerance as JF  # noqa: E402
from repro.runtime import scheduler as JS  # noqa: E402
from repro_torch.launch import workloads as TW  # noqa: E402
from repro_torch.runtime import controller as TC  # noqa: E402
from repro_torch.runtime import fault_tolerance as TF  # noqa: E402
from repro_torch.runtime import scheduler as TS  # noqa: E402
from tests.test_controller import _recorded_trace  # noqa: E402

def _state(c):
    return (c.trajectory, c.events, c.shed_total, c.admission_budget,
            c.depth_budget, c.inflight_budget, c.should_escalate,
            c.summary())


def _ctrl(C, **kw):
    """tests/test_controller.py's ``_ctrl`` on module ``C``."""
    base = dict(targets={"default": C.SLOTarget(p95_ttft_ms=100.0)},
                floor=0.25, step_down=0.25, step_up=0.25,
                window=16, min_samples=1, eval_interval_s=0.0,
                hysteresis=0.7, patience=2, queue_factor=1.0,
                escalate_after=2, sample_ttl_s=100.0)
    base.update(kw)
    return C.SLOController(**base)


def _ladder(C):
    c = _ctrl(C)
    t = 0.0
    for _ in range(9):
        c.record_ttft("default", 0, 500.0, t=t)
        c.update(t, queue_depth=0, capacity=4)
        t += 1.0
    outs = [c.update(t, queue_depth=10, capacity=4),
            c.update(t + 1.0, queue_depth=10, capacity=4)]
    c.notify_remeshed()
    return _state(c), outs


def _hysteresis(C):
    c = _ctrl(C, patience=2)
    c.admission_budget = c.inflight_budget = 0.5
    c.depth_budget = 0.75
    t = 0.0
    for ms, n in ((80.0, 5), (10.0, 10)):
        c._ttft.clear()
        for _ in range(n):
            c.record_ttft("default", 0, ms, t=t)
            c.update(t, queue_depth=0, capacity=4)
            t += 1.0
    return _state(c), (c.admission_cap(), c.depth_cap())


def _queue_and_expiry(C):
    c = _ctrl(C, sample_ttl_s=5.0)
    out = c.update(0.0, queue_depth=9, capacity=4)
    c.record_ttft("default", 0, 1000.0, t=1.0)
    p = c.pressure()
    c.update(10.0, queue_depth=0, capacity=4)
    return _state(c), out, p, c.pressure()


def _lattice(C):
    c = _ctrl(C, step_down=0.37, floor=0.2)
    t = 0.0
    for _ in range(6):
        c.record_ttft("default", 0, 500.0, t=t)
        c.update(t, queue_depth=0, capacity=4)
        t += 1.0
    return _state(c), c.floor, C._quantize(0.001), C.BUDGET_QUANTUM


def _retry_and_rate(C):
    c = _ctrl(C, retry_after_s=2.0)
    r = _ctrl(C, eval_interval_s=1.0)
    outs = [r.update(t, queue_depth=9, capacity=4) for t in (0.0, 0.5, 1.0)]
    return (c.retry_after(0.5), c.retry_after(3.0)), outs, _state(r)


def _recorded(C):
    """tests/test_controller.py's ``_replay_trace`` on module ``C``."""
    c = C.SLOController(
        targets={"default": C.SLOTarget(p95_ttft_ms=100.0, p95_itl_ms=50.0),
                 "batch": C.SLOTarget(p95_ttft_ms=400.0, shed_order=1)},
        floor=0.25, step_up=0.25, eval_interval_s=0.1, min_samples=2,
        patience=1, escalate_after=8, sample_ttl_s=0.5)
    for ev in _recorded_trace():
        if ev[0] == "ttft":
            c.record_ttft(ev[2], ev[3], ev[4], t=ev[1])
        elif ev[0] == "itl":
            c.record_itl(ev[2], ev[3], ev[4], t=ev[1])
        elif ev[0] == "update":
            c.update(ev[1], queue_depth=ev[2], capacity=4)
        elif ev[0] == "remesh":
            c.notify_remeshed()
    return _state(c)


@pytest.mark.parametrize("case", [_ladder, _hysteresis, _queue_and_expiry,
                                  _lattice, _retry_and_rate, _recorded],
                         ids=lambda f: f.__name__.strip("_"))
def test_controller_matches_jax(case, monkeypatch):
    """The same script through both controllers: equal trajectories,
    events, shed totals, budgets and returned decisions, with every wall
    clock raising (the controller reads only injected time)."""
    want = case(JC)

    def boom(*a, **k):
        raise AssertionError("controller read the wall clock")

    for name in ("perf_counter", "time", "monotonic"):
        monkeypatch.setattr(time, name, boom)
    got = case(TC)
    assert got == want


def test_recorded_trace_crosses_every_edge():
    """The recorded trace reaches every stage and restores fully in the
    port, as tests/test_controller.py asserts of JAX's."""
    traj, events, *_ = _recorded(TC)
    kinds = {k for _t, k, _v in events}
    assert {"degrade_admission", "degrade_depth", "degrade_inflight",
            "shed", "escalate", "restore_inflight", "restore_depth",
            "restore_admission"} <= kinds
    assert traj[-1][2:5] == (1.0, 1.0, 1.0)


# -------------------------------- scheduler ----------------------------------

def _scheduler_script(S, seed, flop_budget, n_ops=300):
    """A random sequence of scheduler operations on module ``S``; returns
    the observable trace (handle indices, slots, statuses, reasons,
    costs). Handles are created with a shared fake clock; tenants,
    deadlines, costs, caps and scales drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    clock = TW.StepClock(0.01)
    sch = S.SlotScheduler(4, flop_budget)
    hs, trace = [], []
    idx = {}
    order = {"a": 0, "b": 1, "c": 2}
    for _ in range(n_ops):
        clock.t += float(rng.uniform(0.0, 0.2))
        op = int(rng.integers(9))
        if op <= 1:
            h = S.RequestHandle(None, clock=clock)
            h.tenant = str(rng.choice(["a", "b", "c"]))
            if rng.uniform() < 0.4:
                h.deadline = h.t_submit + float(rng.uniform(0.1, 1.5))
            idx[h.id] = len(hs)
            hs.append(h)
            sch.enqueue(h, float(rng.choice([1.0, 0.75, 0.5, 0.25, 0.0])))
        elif op == 2 and hs:
            h = hs[int(rng.integers(len(hs)))]
            trace.append(("drop", sch.drop_queued(h)))
        elif op == 3:
            cap = [None, 0.5, 0.25][int(rng.integers(3))]
            scale = [None, 0.75, 0.5][int(rng.integers(3))]
            pages = rng.uniform() < 0.3
            check = (lambda h, r: idx[h.id] % 3 != 0) if pages else None
            trace.append(("admit", [(s, idx[h.id]) for s, h in sch.admit(
                page_check=check, cost_cap=cap, cost_scale=scale)]))
        elif op == 4:
            trace.append(("expire", [idx[h.id] for h in
                                     sch.expire_deadlines(clock.t)]))
        elif op == 5:
            prio = (lambda h: order[h.tenant]) if rng.uniform() < 0.5 \
                else None
            trace.append(("shed", [idx[h.id] for h in sch.shed(
                int(rng.integers(0, 3)), priority=prio)]))
        elif op == 6:
            busy = [i for i, h in enumerate(sch.slots) if h is not None]
            if busy:
                slot = int(rng.choice(busy))
                sch.reprice(slot, float(rng.choice([0.5, 0.125, 0.0])))
        elif op == 7:
            busy = [i for i, h in enumerate(sch.slots) if h is not None]
            if busy:
                slot = int(rng.choice(busy))
                h = sch.slots[slot]
                cost = sch.costs[slot]
                sch.free(slot)
                if rng.uniform() < 0.3:            # a preemption
                    sch.requeue_front(h, cost)
                else:
                    h.finish("length")
        else:
            sch.tick()
        trace.append((sch.active, sch.pending, round(sch.used_cost, 12),
                      [idx[h.id] for h, _ in sch.queue],
                      [None if h is None else idx[h.id] for h in sch.slots]))
    trace.append([(h.status, h.finish_reason, h.slot, h.deadline)
                  for h in hs])
    trace.append((sch.steps, sch.occupancy))
    return trace


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("flop_budget", [None, 1.5, 0.6])
def test_scheduler_matches_jax(seed, flop_budget):
    """Tenant classes (FIFO within, earliest head across), deadlines,
    shedding by class priority, repricing, capped and scaled admission
    costs, the page check, preemption re-queues and tombstoned drops: the
    port's single-replica scheduler places and resolves every request
    exactly as JAX's."""
    assert (_scheduler_script(TS, seed, flop_budget)
            == _scheduler_script(JS, seed, flop_budget))


def test_handle_timestamps_come_from_the_clock():
    clock = TW.StepClock(0.01)
    h = TS.RequestHandle(None, clock=clock)
    for t in (0.5, 0.75, 1.5):
        clock.t = t
        h.append(int(t * 4))
    clock.t = 2.0
    h.finish("deadline_exceeded")
    assert (h.t_submit, h.t_first, h.t_tokens, h.t_done) == (
        0.0, 0.5, [0.5, 0.75, 1.5], 2.0)
    assert h.inter_token() == [0.25, 0.75]
    assert h.status == TS.REJECTED and h.done


# ----------------------------- fault tolerance -------------------------------

def test_watchdog_matches_jax():
    rng = np.random.default_rng(0)
    dts = np.concatenate([rng.uniform(0.9, 1.1, 30), [10.0] * 8,
                          rng.uniform(0.9, 1.1, 10), [3.0, 0.1, 5.0]])
    got, want = TF.StragglerWatchdog(threshold=2.0, decay=0.8), \
        JF.StragglerWatchdog(threshold=2.0, decay=0.8)
    flags = [(got.observe(i, float(d)), want.observe(i, float(d)))
             for i, d in enumerate(dts)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert got.flagged == want.flagged and got.ewma == want.ewma


def test_failure_injector_matches_jax():
    def fire(F):
        inj = F.FailureInjector(at_steps=(1, 3, 4))
        out = []
        for s in (0, 1, 1, 2, 3, 4, 4, 5):
            try:
                inj.maybe_fail(s)
                out.append(None)
            except F.SimulatedFailure as e:
                out.append(str(e))
        return out, inj.fired
    assert fire(TF) == fire(JF)


def _training(F, at_steps, save_every, max_restarts=10):
    """tests/test_fault_tolerance.py's stand-in training loop on module
    ``F``: the state, the restarts and the steps each call ran."""
    state = {"w": np.arange(4, dtype=np.float64)}
    ckpt = {"step": 0, "w": state["w"].copy()}
    ran = []

    def do_step(step):
        ran.append(step)
        rng = np.random.default_rng(step)
        state["w"] = state["w"] * 1.25 + rng.normal(size=4)
        return {"step": step}

    def save(step):
        ckpt["step"], ckpt["w"] = step, state["w"].copy()

    def restore():
        state["w"] = ckpt["w"].copy()
        return ckpt["step"]

    try:
        metrics, restarts = F.run_resilient(
            start_step=0, total_steps=9, do_step=do_step, save=save,
            restore=restore, save_every=save_every,
            max_restarts=max_restarts,
            injector=F.FailureInjector(at_steps=at_steps))
    except F.SimulatedFailure:
        return "gave up", ran
    return state["w"].tolist(), restarts, metrics, ran


@pytest.mark.parametrize("at_steps, save_every, max_restarts", [
    ((), 2, 10), ((3, 4, 6), 2, 10), ((2, 5, 8), 3, 10), ((1, 2, 3), 2, 2)])
def test_run_resilient_matches_jax(at_steps, save_every, max_restarts):
    assert (_training(TF, at_steps, save_every, max_restarts)
            == _training(JF, at_steps, save_every, max_restarts))


# -------------------------------- workloads ----------------------------------

@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_arrival_processes_match_jax(kind):
    np.testing.assert_array_equal(TW.arrival_times(kind, 8.0, 50, seed=3),
                                  JW.arrival_times(kind, 8.0, 50, seed=3))
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(
        TW.bursty_times(rng_t, 3.0, 24, burst_factor=4, burst_frac=0.4),
        JW.bursty_times(rng_j, 3.0, 24, burst_factor=4, burst_frac=0.4))


def test_make_requests_matches_jax():
    kw = dict(prompt_lo=64, prompt_hi=512, max_new_lo=16, max_new_hi=64,
              class_mix={"interactive": 0.75, "batch": 0.25}, seed=7)
    got, want = TW.make_requests(24, 1000, **kw), \
        JW.make_requests(24, 1000, **kw)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.max_new_tokens, g.budget, g.seed, g.slo_class,
                g.deadline_ms) == (w.max_new_tokens, w.budget, w.seed,
                                   w.slo_class, w.deadline_ms)
    assert {r.slo_class for r in got} == {"interactive", "batch"}


def _handles(S, seed):
    """Finished handles of module ``S`` with seeded timestamps, outputs,
    tenants, served budgets and terminal states."""
    rng = np.random.default_rng(seed)
    clock = TW.StepClock(0.01)
    hs = []
    for i in range(20):
        clock.t = float(rng.uniform(0, 2))
        h = S.RequestHandle(None, clock=clock)
        h.tenant = ["interactive", "batch"][i % 2]
        fate = int(rng.integers(4))
        if fate == 0:
            h.finish("rejected")
        elif fate == 1:
            h.finish("deadline_exceeded")
        else:
            for _ in range(int(rng.integers(1, 6))):
                clock.t += float(rng.uniform(0.01, 0.3))
                h.append(int(rng.integers(100)))
            h.budget_served = float(rng.choice([1.0, 0.5, 0.25]))
            clock.t += 0.01
            h.finish("length")
        hs.append(h)
    return hs + [None]


def test_summarize_matches_jax():
    targets = {"interactive": JC.SLOTarget(p95_ttft_ms=400.0),
               "batch": JC.SLOTarget(p95_ttft_ms=math.inf)}
    for t in (None, targets):
        got = TW.summarize(_handles(TS, 1), 3.5, t)
        want = JW.summarize(_handles(JS, 1), 3.5, t)
        assert got == want
    assert got["shed"] and got["expired"] and "per_class" in got
