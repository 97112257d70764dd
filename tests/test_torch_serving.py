"""The port's serving engine: greedy tokens identical to the JAX
``ServingEngine`` on a staggered mixed-budget workload, staggered == solo
inside the port, decode steps whose tensor shapes and dtypes never change
with the budget mix, and no silent CPU fallback.

Routing decisions are held equal by a seed whose router logits clear their
thresholds by more than 1e-4 throughout the run (asserted).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.runtime.mesh import abstract_mesh  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402
from tests.test_torch_interop import RouterMargins, toy_pair  # noqa: E402

BATCH, MAX_SEQ, PLEN, NEW = 3, 40, 10, 8
BUDGETS = [1.0, 0.5, None, 0.75, 0.5]


@pytest.fixture(scope="module")
def setup():
    s = toy_pair(seed=2)
    rng = np.random.default_rng(2)
    s["prompts"] = [rng.integers(0, s["tcfg"].vocab_size, PLEN,
                                 dtype=np.int64).astype(np.int32)
                    for _ in BUDGETS]
    return s


def _staggered(engine, make_req, prompts, budgets):
    """Two requests, two steps, the rest: admissions land mid-decode."""
    handles = [engine.submit(make_req(p, NEW, budget=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(make_req(p, NEW, budget=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return [list(h.output) for h in handles]


def _port_engine(s, **kw):
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu", **kw)


def test_greedy_tokens_match_jax_engine(setup, monkeypatch):
    s = setup
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ)
    want = _staggered(jeng, JaxRequest, s["prompts"], BUDGETS)
    margins = RouterMargins(monkeypatch)
    got = _staggered(_port_engine(s), GenRequest, s["prompts"], BUDGETS)
    margins.check()
    assert got == want


def test_staggered_equals_solo_and_shapes_never_change(setup, monkeypatch):
    """Each request served alone gives its staggered tokens; every decode
    step of the mixed-budget run sees the same tensor shapes, dtypes and
    storage (the port's counterpart of one compiled decode graph, and the
    precondition of replaying a captured one), one call a step."""
    s = setup
    sigs, calls = set(), []
    real = serve_mod.decode_step

    def recording(params, rp, tok, caches, t, cfg, spec, mode, policy):
        leaves = [tok, t] + [getattr(policy, f) for f in (
            "mlp_token_capacity", "mha_token_capacity", "mha_head_topk",
            "theta", "student")]
        leaves += [c for layer in caches["layers"]
                   for c in layer["attn"].values()]
        sigs.add(tuple((tuple(x.shape), x.dtype, x.data_ptr())
                       for x in leaves))
        calls.append(1)
        return real(params, rp, tok, caches, t, cfg, spec, mode=mode,
                    policy=policy)

    monkeypatch.setattr(serve_mod, "decode_step", recording)
    eng = _port_engine(s)
    stag = _staggered(eng, GenRequest, s["prompts"], BUDGETS)
    assert len(sigs) == 1 and len(calls) == eng.timing["decode_steps"]
    for i in (1, 3, 4):
        solo = _port_engine(s).generate(
            [GenRequest(s["prompts"][i], NEW, budget=BUDGETS[i])])[0]
        assert list(solo) == stag[i]


def test_budget_one_rows_equal_the_teacher(setup):
    s = setup
    base = ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode="base", batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu")
    teacher = _staggered(base, GenRequest, s["prompts"], [None] * 5)
    elastic = _staggered(_port_engine(s), GenRequest, s["prompts"], BUDGETS)
    for i, b in enumerate(BUDGETS):
        if b in (None, 1.0):
            assert elastic[i] == teacher[i]
    assert any(elastic[i] != teacher[i] for i, b in enumerate(BUDGETS)
               if b is not None and b < 1.0)


def test_eos_and_cancel_free_their_slots(setup):
    s = setup
    eng = _port_engine(s)
    first = eng.generate([GenRequest(s["prompts"][0], NEW)])[0]
    h = eng.submit(GenRequest(s["prompts"][0], NEW, eos_id=int(first[2])))
    h2 = eng.submit(GenRequest(s["prompts"][1], NEW))
    assert h.result() == list(first[:3]) and h.finish_reason == "eos"
    assert eng.cancel(h2) or h2.done
    assert not eng.has_work


@pytest.mark.parametrize("flop_budget", [None, 1.5, 0.6])
def test_scheduler_admits_like_the_jax_scheduler(flop_budget):
    """The port's single-device scheduler places requests exactly as the
    JAX package's (one replica, one tenant class) over a random sequence
    of submits, drops, admissions and frees."""
    from repro.runtime import scheduler as jsched
    from repro_torch.runtime import scheduler as tsched
    rng = np.random.default_rng(7)
    ours, theirs = tsched.SlotScheduler(4, flop_budget), \
        jsched.SlotScheduler(4, flop_budget)
    pairs = []
    for _ in range(200):
        op = rng.integers(4)
        if op == 0:
            cost = float(rng.choice([1.0, 0.75, 0.5, 0.25, 0.0]))
            pair = (tsched.RequestHandle(None), jsched.RequestHandle(None))
            ours.enqueue(pair[0], cost)
            theirs.enqueue(pair[1], cost)
            pairs.append(pair)
        elif op == 1 and pairs:
            a, b = pairs[rng.integers(len(pairs))]
            assert ours.drop_queued(a) == theirs.drop_queued(b)
        elif op == 2:
            got = [(s, pairs.index(next(p for p in pairs if p[0] is h)))
                   for s, h in ours.admit()]
            want = [(s, pairs.index(next(p for p in pairs if p[1] is h)))
                    for s, h in theirs.admit()]
            assert got == want
        else:
            busy = [i for i, h in enumerate(ours.slots) if h is not None]
            if busy:
                slot = int(rng.choice(busy))
                ours.free(slot)
                theirs.free(slot)
        ours.tick()
        theirs.tick()
        assert (ours.active, ours.pending) == (theirs.active, theirs.pending)
    assert ours.occupancy == theirs.occupancy


def test_no_silent_cpu_fallback(setup):
    s = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"])
    # serving on a (data, model) mesh is ported: it takes a rank's shard
    with pytest.raises(ValueError, match="shard"):
        _port_engine(s, mesh=abstract_mesh((2, 2), ("data", "model")))
    with pytest.raises(TypeError, match="runtime.mesh.Mesh"):
        _port_engine(s, mesh=object())
    # the SLO controller is ported: on the CPU a controller engine builds
    from repro_torch.runtime.controller import SLOController
    ctrl = SLOController()
    eng = _port_engine(s, controller=ctrl)
    assert eng.controller is ctrl and eng.device.type == "cpu"
    with pytest.raises(TypeError, match="runtime.mesh.Mesh"):
        eng.reshard(object())
    with pytest.raises(ValueError, match="process world"):
        eng.reshard(abstract_mesh((1, 2), ("data", "model")))
    # quantized serving is ported: on the CPU an int8 engine builds
    eng = _port_engine(s, kv_dtype="int8", weight_dtype="int8")
    attn = eng._caches["layers"][0]["attn"]
    assert attn["k"].dtype == torch.int8 and "kscale" in attn
    assert eng.params["layers"][0]["mlp"]["wi"].dtype == torch.int8
    with pytest.raises(ValueError):
        _port_engine(s, kv_dtype="int4")
