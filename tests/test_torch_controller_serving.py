"""The SLO controller, fault tolerance and trace replay on the port's
serving engine, against the JAX package's engine on the CPU.

toy-lm from ``toy_pair`` in f32 (the serving slice's spec with the depth
router, so the controller's depth stage has something to act on). JAX runs its kernels' jnp references, the port its kernels'
plain versions (CPU tensors); the kernels themselves are held to each
other by the other parity files. Both engines read one injected
``StepClock`` advanced 0.1 s per step, so every timestamp, deadline and
controller evaluation is a function of the step count. Held equal to JAX,
exactly (the controller and scheduler compute in Python floats; the
tokens are greedy):
  * tests/test_controller.py:241-300's scenarios on the ring and (the
    ladder) on the paged pool: every request's status, finish reason,
    ``retry_after``, ``budget_served``, tokens and timestamps, the
    engine's ``n_rejected`` / ``n_expired``, the controller's ``events``
    and ``trajectory``;
  * tests/test_depth.py:199-233's live depth degrade and restore, with the
    depth router;
  * ``serve_resilient`` and ``replay`` with a failure injected mid-run: the
    port's tokens equal JAX's and the port's fault-free run.
The port's own: ``compile_counts()`` flat across every stage (ring
{prefill 0, decode 1}, paged {1, 1}), ``reshard(None)`` restarting the
counts, ``maybe_escalate`` re-meshing a ring engine and declining on a
paged one, and the paged prefix namespace: pages are shared between two
requests only when no degrade fell between their admissions.

Routing decisions are held equal by a seed whose router logits clear their
thresholds by more than 1e-4 throughout the port's runs (asserted).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

from repro.runtime import controller as JC  # noqa: E402
from repro.runtime import fault_tolerance as JF  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.launch.workloads import StepClock, replay  # noqa: E402
from repro_torch.runtime import controller as TC  # noqa: E402
from repro_torch.runtime import fault_tolerance as TF  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from tests.test_torch_interop import SPEC_KW, RouterMargins, toy_pair  # noqa: E402

BATCH, MAX_SEQ, PLEN, NEW, PS = 2, 24, 8, 8, 8
TICK = 0.1


@functools.lru_cache(maxsize=None)
def pair():
    s = toy_pair(seed=1, spec_kw=dict(SPEC_KW, depth_routed=True))
    # the JAX engine on its kernels' jnp references: the engine runs here
    # are about the controller and the scheduler, which no kernel touches
    s["jspec"] = dataclasses.replace(s["jspec"], kernel_backend="ref")
    return s


@dataclasses.dataclass
class Side:
    """One package's engine, request and controller types on the pair's
    weights."""
    jax: bool
    s: dict

    @property
    def C(self):
        return JC if self.jax else TC

    @property
    def R(self):
        return JaxRequest if self.jax else GenRequest

    def engine(self, layout="ring", **kw):
        if layout == "paged":
            kw.update(kv_layout="paged", page_size=PS)
        if self.jax:
            return JaxEngine(self.s["params"], self.s["rp"], self.s["jcfg"],
                             self.s["jspec"], mode="infer",
                             batch_size=BATCH, max_seq=MAX_SEQ, **kw)
        return ServingEngine(self.s["tparams"], self.s["trp"],
                             self.s["tcfg"], self.s["tspec"], mode="infer",
                             batch_size=BATCH, max_seq=MAX_SEQ, device="cpu",
                             **kw)


def _prompts(s, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, s["tcfg"].vocab_size, PLEN).astype(np.int32)
            for _ in range(n)]


def _outcome(eng, ctrl, handles):
    return {"handles": [(h.status, h.finish_reason, h.retry_after,
                         h.budget_served, [int(x) for x in h.output],
                         h.t_submit, h.t_first, h.t_done, h.deadline)
                        for h in handles],
            "n_rejected": eng.n_rejected, "n_expired": eng.n_expired,
            "events": list(ctrl.events), "trajectory": list(ctrl.trajectory),
            "summary": ctrl.summary()}


def _ladder(side, layout):
    """tests/test_controller.py:241-278: every target over, ten requests on
    two slots; the ladder walks admission, depth, in-flight, then sheds
    and escalates."""
    clock = StepClock(TICK)
    ctrl = side.C.SLOController(
        targets={"default": side.C.SLOTarget(p95_ttft_ms=1.0)},
        floor=0.25, step_down=0.25, window=8, min_samples=1,
        eval_interval_s=0.0, queue_factor=1.0, escalate_after=2,
        retry_after_s=1.0, sample_ttl_s=1e9)
    eng = side.engine(layout, controller=ctrl, clock=clock)
    hs = [eng.submit(side.R(p, NEW, seed=i))
          for i, p in enumerate(_prompts(side.s, 10))]
    for _ in range(60):
        clock.tick()
        if eng.step() == 0 and not eng.has_work:
            break
    return eng, _outcome(eng, ctrl, hs)


def _deadline(side, layout):
    """tests/test_controller.py:280-300: a class deadline expires a queued
    request before its prefill; an explicit deadline overrides it."""
    clock = StepClock(TICK)
    ctrl = side.C.SLOController(
        targets={"default": side.C.SLOTarget(deadline_ms=50.0)},
        eval_interval_s=1e9)
    eng = side.engine(layout, controller=ctrl, clock=clock)
    h = eng.submit(side.R(np.arange(PLEN, dtype=np.int32), 4))
    clock.t += 0.2
    eng.step()
    h2 = eng.submit(side.R(np.arange(PLEN, dtype=np.int32), 4,
                           deadline_ms=10 ** 6))
    clock.t += 0.2
    while not h2.done:
        clock.tick()
        eng.step()
    return eng, _outcome(eng, ctrl, [h, h2])


def _depth(side, layout):
    """tests/test_depth.py:199-233 on the injected clock: the depth stage
    set mid-flight splices into the in-flight rows at the next evaluation
    and caps the next admissions; set back, later admissions return to the
    full-depth cost."""
    clock = StepClock(TICK)
    ctrl = side.C.SLOController(
        targets={"default": side.C.SLOTarget(p95_ttft_ms=500.0)},
        floor=0.25)
    eng = side.engine(layout, controller=ctrl, clock=clock)
    reqs = [side.R(p, NEW, budget=0.8) for p in _prompts(side.s, 4, seed=4)]

    def step():
        clock.tick()
        eng.step()
    hs = [eng.submit(reqs[0]), eng.submit(reqs[1])]
    step()
    step()
    ctrl.depth_budget = 0.5
    step()
    hs += [eng.submit(reqs[2]), eng.submit(reqs[3])]
    while not all(h.done for h in hs):
        step()
    ctrl.depth_budget = 1.0
    hs.append(eng.submit(reqs[0]))
    while not hs[-1].done:
        step()
    return eng, _outcome(eng, ctrl, hs)


def _restore(side, layout):
    """A controller degraded to its floor on every stage and then healthy
    (generous targets, one healthy evaluation per restore): it restores
    in-flight, depth, then admission, each splicing the live rows of the
    requests admitted degraded back up; the next pair is admitted at full
    budget."""
    clock = StepClock(TICK)
    ctrl = side.C.SLOController(
        targets={"default": side.C.SLOTarget(p95_ttft_ms=1e6)}, floor=0.25,
        step_up=0.25, eval_interval_s=0.0, patience=1, min_samples=1)
    ctrl.admission_budget = ctrl.depth_budget = ctrl.inflight_budget = 0.25
    eng = side.engine(layout, controller=ctrl, clock=clock)
    hs = []
    for pair_ in np.split(np.arange(4), 2):
        ps = _prompts(side.s, 4, seed=6)
        hs += [eng.submit(side.R(ps[i], 12, seed=int(i))) for i in pair_]
        while not all(h.done for h in hs):
            clock.tick()
            eng.step()
    return eng, _outcome(eng, ctrl, hs)


SCENARIOS = {"ladder-ring": (_ladder, "ring"),
             "ladder-paged": (_ladder, "paged"),
             "deadline-ring": (_deadline, "ring"),
             "depth-ring": (_depth, "ring"),
             "restore-paged": (_restore, "paged")}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_engine_matches_jax(name, monkeypatch):
    fn, layout = SCENARIOS[name]
    jeng, want = fn(Side(True, pair()), layout)
    margins = RouterMargins(monkeypatch)
    eng, got = fn(Side(False, pair()), layout)
    margins.check()
    assert got == want
    # the one-capture contract survives every stage: the JAX engine's
    # {prefill: 1, decode: 1}, the ring's admission eager in the port
    assert jeng.compile_counts() == {"prefill": 1, "decode": 1}
    assert eng.compile_counts() == {"prefill": int(layout == "paged"),
                                    "decode": 1}
    kinds = [k for _t, k, _v in got["events"]]
    hs = got["handles"]
    if name.startswith("ladder"):
        assert kinds.index("degrade_admission") < kinds.index(
            "degrade_depth") < kinds.index("degrade_inflight") < kinds.index(
            "shed") < kinds.index("escalate")
        shed = [h for h in hs if h[1] == "rejected"]
        assert shed and all(h[0] == "rejected" and h[2] >= 1.0
                            for h in shed)
        assert got["n_rejected"] == len(shed)
        served = [h for h in hs if h[0] == "done"]
        assert served and any(h[3] < 1.0 for h in served)
    elif name.startswith("deadline"):
        assert hs[0][:2] == ("rejected", "deadline_exceeded")
        assert hs[0][6] is None and got["n_expired"] == 1   # no prefill
        assert hs[1][0] == "done"
    elif name.startswith("depth"):
        # admissions under the depth cap serve the composed cost, the
        # in-flight rows were spliced down to it, and after the cap is
        # lifted an admission is back at its own budget
        assert [h[3] for h in hs] == pytest.approx([0.4] * 4 + [0.8])
        assert all(len(h[4]) == NEW for h in hs)
    else:
        assert kinds == ["restore_inflight"] * 3 + ["restore_depth"] * 3 \
            + ["restore_admission"] * 3
        assert [h[3] for h in hs] == [0.0625] * 2 + [1.0] * 2


# ----------------------------- fault tolerance -------------------------------

def _fault_requests(R, s):
    budgets = (0.5, 1.0, None)
    return [R(p, 6, budget=budgets[i % 3], seed=i)
            for i, p in enumerate(_prompts(s, 6, seed=13))]


@functools.lru_cache(maxsize=None)
def jax_resilient():
    """JAX's serve_resilient with a failure at step 2: onto a 1x1 mesh
    after the 4096-device shape is skipped."""
    side = Side(True, pair())
    eng = side.engine()
    hs = [eng.submit(r) for r in _fault_requests(JaxRequest, side.s)]
    steps, restarts = JF.serve_resilient(
        eng, fallback_shapes=[(64, 64), (1, 1)], max_restarts=2,
        injector=JF.FailureInjector(at_steps=(2,)),
        watchdog=JF.StragglerWatchdog())
    assert restarts == 1
    return [[int(x) for x in h.output] for h in hs]


def test_serve_resilient_and_replay_match_jax():
    """A failure mid-serve drains and re-meshes the port's engine onto one
    device (the 4096-device shape skipped): every request finishes with
    the tokens of JAX's resilient run and of the port's fault-free run,
    through ``serve_resilient`` and through ``replay``; the captured forms
    restart at the re-mesh and are built once after it."""
    want = jax_resilient()
    side = Side(False, pair())
    reqs = _fault_requests(GenRequest, side.s)
    clean = [[int(x) for x in o] for o in side.engine().generate(reqs)]
    assert clean == want

    eng = side.engine()
    hs = [eng.submit(r) for r in reqs]
    counts = []
    real_reshard = eng.reshard

    def reshard(mesh):
        real_reshard(mesh)
        counts.append(eng.compile_counts())
    eng.reshard = reshard
    wd = TF.StragglerWatchdog()
    steps, restarts = TF.serve_resilient(
        eng, fallback_shapes=[(64, 64), (1, 1)], max_restarts=2,
        injector=TF.FailureInjector(at_steps=(2,)), watchdog=wd)
    assert (restarts, steps > 0, eng.mesh) == (1, True, None)
    assert counts == [{"prefill": 0, "decode": 0}]       # restarted
    assert eng.compile_counts() == {"prefill": 0, "decode": 1}
    assert eng.remeshed_at is not None and wd.ewma is not None
    assert all(h.finish_reason == "length" for h in hs)
    assert [[int(x) for x in h.output] for h in hs] == want

    eng = side.engine()
    handles, _dt, info = replay(
        eng, reqs, np.arange(len(reqs)) * 1e-3, fallback_shapes=[(1, 1)],
        injector=TF.FailureInjector(at_steps=(3,)),
        watchdog=TF.StragglerWatchdog())
    assert info["restarts"] == 1
    assert all(h.status == "done" for h in handles)
    assert [[int(x) for x in h.output] for h in handles] == want


def _saturated(C):
    c = C.SLOController(floor=0.25, escalate_after=1, eval_interval_s=0.0)
    c.admission_budget = c.depth_budget = c.inflight_budget = 0.25
    return c


def test_maybe_escalate_remeshes_ring_and_declines_paged():
    """tests/test_fault_tolerance.py:169-199 on the port: a saturated
    controller re-meshes a ring engine onto one device (the unusable shape
    skipped, the list consumed, the latch re-armed) and a paged engine
    declines (latch re-armed, no re-mesh); more than one device, or a
    mesh without a process world, raises."""
    side = Side(False, pair())
    ctrl = _saturated(TC)
    eng = side.engine(controller=ctrl)
    assert ctrl.update(1.0, queue_depth=100, capacity=2)["escalate"]
    shapes = [(64, 64), (1, 1)]
    assert TF.maybe_escalate(eng, shapes)
    assert shapes == [] and not ctrl.should_escalate
    assert eng.mesh is None and eng.remeshed_at is not None
    assert not TF.maybe_escalate(eng, [(1, 1)])          # latch re-armed
    ctrl.update(2.0, queue_depth=100, capacity=2)
    assert not TF.maybe_escalate(eng, [])                # nothing left
    assert not ctrl.should_escalate
    with pytest.raises(TypeError, match="runtime.mesh.Mesh"):
        eng.reshard(object())

    ctrl = _saturated(TC)
    paged = side.engine("paged", controller=ctrl)
    ctrl.update(1.0, queue_depth=100, capacity=2)
    shapes = [(1, 1)]
    assert not TF.maybe_escalate(paged, shapes)
    assert shapes == [(1, 1)] and not ctrl.should_escalate
    assert paged.remeshed_at is None
    with pytest.raises(NotImplementedError):
        paged.reshard(None)


# ---------------------------- prefix namespace -------------------------------

@pytest.mark.parametrize("degrade", [None, "admission", "depth"])
def test_prefix_pages_shared_only_within_one_budget(degrade, monkeypatch):
    """Two requests with a common 16-token prefix on the paged engine: the
    second shares the first's 2 prefix pages when nothing changed between
    their admissions, and shares none when the controller degraded the
    admission budget or the depth between them (the pages hold K/V
    written at another budget). Either way its tokens equal a run alone
    at the budget it was served at."""
    s = pair()
    side = Side(False, s)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, s["tcfg"].vocab_size, 2 * PS).astype(np.int32)
    tails = [rng.integers(0, s["tcfg"].vocab_size, 3).astype(np.int32)
             for _ in range(2)]
    reqs = [GenRequest(np.concatenate([prefix, t]), 4) for t in tails]

    def controlled(preset=None):
        c = TC.SLOController(eval_interval_s=1e9)
        if preset == "admission":
            c.admission_budget = 0.5
        elif preset == "depth":
            c.depth_budget = 0.5
        return c

    margins = RouterMargins(monkeypatch)
    ctrl = controlled()
    eng = side.engine("paged", controller=ctrl, clock=StepClock(TICK))
    h0 = eng.submit(reqs[0])
    eng.step()
    ctrl.admission_budget, ctrl.depth_budget = \
        controlled(degrade).admission_budget, controlled(degrade).depth_budget
    h1 = eng.submit(reqs[1])
    eng.step()
    shared = eng.pool.stats()["shared"]
    while not (h0.done and h1.done):
        eng.step()
    margins.check()
    assert shared == (2 if degrade is None else 0)
    assert eng.paged_stats()["allocated"] == 0
    solo = side.engine("paged", controller=controlled(degrade),
                       clock=StepClock(TICK)).generate([reqs[1]])[0]
    assert list(h1.output) == [int(x) for x in solo]
