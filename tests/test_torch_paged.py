"""The port's paged-KV serving against the JAX package's, at toy-lm size in
f32: the page pool, the scheduler's page check, the plain paged decode
attention, one decode step and one prefill chunk on the same filled pool,
and the paged engine (staggered mixed budgets, prefix sharing, cancel, CoW
fork, preemption) — greedy only, ``page_size`` 8, ``max_seq`` 64.

JAX runs its Pallas kernels in interpret mode, the port its kernels' plain
versions (CPU tensors). Attention outputs, logits and pools are held to
f32 rtol=atol=1e-5; tokens are held equal exactly, with the routing
decisions held equal by seeds whose router logits clear their thresholds
by more than 1e-4 (asserted).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.ref import \
    paged_decode_attention_ref as jax_paged_ref  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models.model import paged_cache_init as jax_paged_cache_init  # noqa: E402
from repro.models.model import prefill_chunk_step as jax_chunk  # noqa: E402
from repro.runtime import pagedkv as jpk  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.core.policy import ElasticPolicy  # noqa: E402
from repro_torch.interop import caches_from_numpy  # noqa: E402
from repro_torch.kernels.ref import paged_decode_attention_ref  # noqa: E402
from repro_torch.models import decode_step, prefill_chunk_step  # noqa: E402
from repro_torch.runtime import pagedkv as tpk  # noqa: E402
from repro_torch.runtime import scheduler as tsched  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402
from tests.test_torch_cuda import PAGED_CASES, as_t, paged_inputs  # noqa: E402
from tests.test_torch_interop import RouterMargins, toy_pair  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, MAX_SEQ, PS = 2, 64, 8
N_HEADS = 4


@pytest.fixture(scope="module")
def setup():
    return toy_pair(seed=0)


def _engine(s, mode="infer", **kw):
    kw = {"kv_layout": "paged", "page_size": PS, **kw}
    if kw["kv_layout"] == "ring":
        kw.pop("page_size")
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu", **kw)


def _ring_solo(s, prompt, n, budget):
    return list(_engine(s, kv_layout="ring").generate(
        [GenRequest(prompt, n, budget=budget)])[0])


def _drain(eng, handles):
    while not all(h.done for h in handles):
        assert eng.step() > 0, "engine stalled"


def _prompts(s, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, s["tcfg"].vocab_size, n, dtype=np.int64)
            .astype(np.int32) for n in lens]


# ------------------------------ pool (unit) ----------------------------------

def test_pool_and_keys_match_the_jax_pool():
    """The same random call sequence on both pools gives the same ids,
    refcounts, registry hits and stats, double frees included."""
    rng = np.random.default_rng(0)
    ours, theirs = tpk.PagePool(13, 4), jpk.PagePool(13, 4)
    assert ours.trash_page(0) == theirs.trash_page(0) == 12
    held = []
    for step in range(300):
        op = rng.integers(5)
        if op == 0:
            n = int(rng.integers(0, 5))
            a, b = ours.alloc(0, n), theirs.alloc(0, n)
            assert a == b
            held += a or []
        elif op == 1 and held:
            pages = [held.pop(int(rng.integers(len(held))))
                     for _ in range(int(rng.integers(1, min(3, len(held)) + 1)))]
            ours.free(pages)
            theirs.free(pages)
        elif op == 2 and held:
            p = held[int(rng.integers(len(held)))]
            ours.incref(p)
            theirs.incref(p)
            held.append(p)
        elif op == 3 and held:
            key = ("k", int(rng.integers(6)))
            p = held[int(rng.integers(len(held)))]
            ours.register_prefix(key, p)
            theirs.register_prefix(key, p)
        else:
            key = ("k", int(rng.integers(6)))
            assert ours.lookup_prefix(key, 0) == theirs.lookup_prefix(key, 0)
        assert ours.stats() == theirs.stats()
        assert ours.can_alloc(0, 3) == theirs.can_alloc(0, 3)
    ours.free(held)
    theirs.free(held)
    assert ours.stats() == theirs.stats() and ours.allocated == 0
    for pool in (ours, theirs):
        [p] = pool.alloc(0, 1)
        with pytest.raises(RuntimeError, match="double free"):
            pool.free([p, p])
    for n in (0, 1, 7, 8, 9, 64):
        assert tpk.n_pages_for(n, 8) == jpk.n_pages_for(n, 8)
    toks = rng.integers(0, 50, 37)
    for ns in [(), ("infer", 0.5, 0.5, "fp32", None),
               ("infer", 1.0, 0.5, "fp32", None)]:
        assert tpk.prefix_keys(toks, 8, ns) == jpk.prefix_keys(toks, 8, ns)
    assert tpk.prefix_keys(toks, 8, ("a",)) != tpk.prefix_keys(toks, 8, ("b",))


@pytest.mark.parametrize("flop_budget", [None, 1.5])
def test_scheduler_page_check_admits_like_the_jax_scheduler(flop_budget):
    """Admission with a page check against a shared page count, frees and
    front re-queues (preemption) place requests exactly as the JAX
    scheduler does: a head that cannot get its pages waits."""
    rng = np.random.default_rng(3)
    ours, theirs = tsched.SlotScheduler(3, flop_budget), \
        jsched.SlotScheduler(3, flop_budget)
    pairs, need, held = [], {}, {}
    state = {"free": 10}

    def check(handle, replica):
        assert replica == 0
        return need[id(handle)] <= state["free"]

    def idx(h, side):
        return next(i for i, p in enumerate(pairs) if p[side] is h)

    for _ in range(300):
        op = rng.integers(5)
        if op == 0:
            cost = float(rng.choice([1.0, 0.75, 0.5, 0.25]))
            pair = (tsched.RequestHandle(None), jsched.RequestHandle(None))
            n = int(rng.integers(1, 7))
            for h in pair:
                need[id(h)] = n
            ours.enqueue(pair[0], cost)
            theirs.enqueue(pair[1], cost)
            pairs.append(pair)
        elif op == 1:
            got = [(s, idx(h, 0)) for s, h in ours.admit(page_check=check)]
            want = [(s, idx(h, 1)) for s, h in theirs.admit(page_check=check)]
            assert got == want
            for s, i in got:
                held[s] = need[id(pairs[i][0])]
                state["free"] -= held[s]
        elif op in (2, 3):
            busy = [i for i, h in enumerate(ours.slots) if h is not None]
            if busy:
                slot = int(rng.choice(busy))
                state["free"] += held.pop(slot)
                if op == 3:                   # preempted: back to the front
                    hs = ours.slots[slot], theirs.slots[slot]
                    cost = ours.costs[slot]
                    assert cost == theirs.costs[slot]
                    ours.free(slot)
                    theirs.free(slot)
                    ours.requeue_front(hs[0], cost)
                    theirs.requeue_front(hs[1], cost)
                    assert hs[0].status == hs[1].status == "queued"
                else:
                    ours.free(slot)
                    theirs.free(slot)
        elif pairs:
            a, b = pairs[rng.integers(len(pairs))]
            assert ours.drop_queued(a) == theirs.drop_queued(b)
        assert (ours.active, ours.pending) == (theirs.active, theirs.pending)
        assert ours.free_slots_in(0) == theirs.free_slots_in(0)
    assert ours.replica_of(2) == theirs.replica_of(2) == 0
    assert ours.slots_per_replica == theirs.slots_per_replica


# ------------------------- plain paged decode attention ----------------------

@pytest.mark.parametrize("case", PAGED_CASES, ids=range(len(PAGED_CASES)))
def test_paged_plain_matches_pallas(case):
    q, kp, vp, table, t, pvalid = paged_inputs(case, 1)
    args = [jnp.asarray(a) for a in (q, kp, vp, table, t, pvalid)]
    want = np.asarray(jax_paged(*args, interpret=True))
    want_ref = np.asarray(jax_paged_ref(*args))
    got = paged_decode_attention_ref(*(as_t(a) for a in (
        q, kp, vp, table, t, pvalid))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    dead = (table < 0).all(1)
    assert not got[dead].any()                  # exact zeros, as the kernel


# -------------------- model steps on the same filled pool --------------------

def _filled_pools(s, n_pages, seed):
    """A JAX paged cache filled with random K/V and validity, and the same
    pools carried into the port by ``interop.caches_from_numpy``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_paged_cache_init(s["jcfg"], n_pages, PS))

    def fill(a):
        if a.dtype == bool:
            return rng.random(a.shape) < 0.8
        return rng.standard_normal(a.shape).astype(a.dtype)
    tree = jax.tree.map(fill, tree)
    return tree, caches_from_numpy(tree, s["tcfg"], device="cpu")


def _check_pools(tree, jc, tc):
    """Port pools against JAX pools, layer by layer."""
    for i, layer in enumerate(tc["layers"]):
        ja = jax.tree.map(lambda a: np.asarray(a[i]), jc["scan"][0])
        for name in ("kp", "vp"):
            np.testing.assert_allclose(layer["attn"][name].numpy(),
                                       ja["attn"][name], **TOL)
        np.testing.assert_array_equal(layer["attn"]["pvalid"].numpy(),
                                      ja["attn"]["pvalid"])


def test_interop_carries_a_jax_pool_bit_for_bit(setup):
    s = setup
    tree, tc = _filled_pools(s, 9, 0)
    assert len(tc["layers"]) == s["tcfg"].n_layers
    for i, layer in enumerate(tc["layers"]):
        for name in ("kp", "vp", "pvalid"):
            np.testing.assert_array_equal(
                layer["attn"][name].numpy(), tree["scan"][0]["attn"][name][i])


@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_step_matches_jax_on_a_filled_pool(setup, monkeypatch, kind):
    """One ``decode_step(table=, trash=)`` (3 slots: mid-page, page
    boundary, inactive) or one ``prefill_chunk_step`` (a final chunk with
    padding) of the port against the JAX one on the same filled pool and
    table, independent of any prefill: logits and every layer's pools."""
    s = setup
    margins = RouterMargins(monkeypatch)
    N = 12
    tree, tc = _filled_pools(s, N, 1)
    jc = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(2)
    if kind == "decode":
        table = np.full((3, 4), -1, np.int32)
        table[0, :2] = [7, 2]                     # t = 12: mid-page 1
        table[1, :3] = [0, 9, 4]                  # t = 16: first lane of 2
        t = np.asarray([12, 16, 40], np.int32)    # slot 2: inactive
        trash = np.full((3,), N - 1, np.int32)
        tok = rng.integers(0, s["tcfg"].vocab_size, (3, 1)).astype(np.int32)
        budgets = [0.5, 1.0, 0.75]
        jp = JaxPolicy.stack([JaxPolicy.uniform(b, n_heads=N_HEADS)
                              for b in budgets])
        tp = ElasticPolicy.stack([ElasticPolicy.uniform(b, n_heads=N_HEADS)
                                  for b in budgets])
        jl, jc = jax_decode_step(
            s["params"], s["rp"], jnp.asarray(tok), jc, jnp.asarray(t),
            s["jcfg"], s["jspec"], mode="infer", policy=jp,
            table=jnp.asarray(table), trash=jnp.asarray(trash))
        tl, tc = decode_step(
            s["tparams"], s["trp"], torch.from_numpy(tok), tc,
            torch.from_numpy(t), s["tcfg"], s["tspec"], mode="infer",
            policy=tp, table=torch.from_numpy(table),
            trash=torch.from_numpy(trash))
    else:
        row = np.asarray([5, 8, 1, -1, -1, -1, -1, -1], np.int32)
        pos0, plen = 16, 21                        # 5 real tokens of 8
        tok = np.zeros((1, PS), np.int32)
        tok[0, :plen - pos0] = rng.integers(0, s["tcfg"].vocab_size,
                                            plen - pos0)
        jp = JaxPolicy.uniform(0.5, n_heads=N_HEADS)
        tp = ElasticPolicy.uniform(0.5, n_heads=N_HEADS)
        jl, jc = jax_chunk(
            s["params"], s["rp"], jnp.asarray(tok), jc, jnp.int32(1),
            jnp.asarray(row), jnp.int32(pos0), jnp.int32(plen), s["jcfg"],
            s["jspec"], mode="infer", policy=jp)
        tl, tc = prefill_chunk_step(
            s["tparams"], s["trp"], torch.from_numpy(tok), tc, 1,
            torch.from_numpy(row), pos0, plen, s["tcfg"], s["tspec"],
            mode="infer", policy=tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_pools(tree, jc, tc)
    margins.check()


# --------------------------------- engine ------------------------------------

LENS = (5, 13, 16, 29)
BUDGETS = (0.4, 1.0, None, 0.75)


def _staggered(eng, make_req, prompts):
    """The JAX paged test's workload: r0 mid-flight when r1 lands, then
    r2 and r3 together, into 2 slots."""
    reqs = [make_req(p, 6, budget=b) for p, b in zip(prompts, BUDGETS)]
    h0 = eng.submit(reqs[0])
    eng.step()
    eng.step()
    h1 = eng.submit(reqs[1])
    eng.step()
    handles = [h0, h1, eng.submit(reqs[2]), eng.submit(reqs[3])]
    _drain(eng, handles)
    return [list(h.output) for h in handles]


def test_paged_engine_matches_jax_paged_engine(setup, monkeypatch):
    s = setup
    prompts = _prompts(s, 0, LENS)
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
                     kv_layout="paged", page_size=PS)
    want = _staggered(jeng, JaxRequest, prompts)
    margins = RouterMargins(monkeypatch)
    eng = _engine(s)
    got = _staggered(eng, GenRequest, prompts)
    margins.check()
    assert got == [[int(x) for x in w] for w in want]
    st = eng.paged_stats()
    assert st["allocated"] == 0 and st["free"] == st["usable"]


def test_paged_equals_ring_and_shapes_never_change(setup, monkeypatch):
    """Port paged == port ring (each request served alone), token for
    token; every decode step of the staggered run sees the same tensor
    shapes, dtypes and storage, page table and trash pages included, one
    call a step."""
    s = setup
    prompts = _prompts(s, 0, LENS)
    sigs, calls = set(), []
    real = serve_mod.decode_step

    def recording(params, rp, tok, caches, t, cfg, spec, mode, policy,
                  table, trash):
        leaves = [tok, t, table, trash] + [getattr(policy, f) for f in (
            "mlp_token_capacity", "mha_token_capacity", "mha_head_topk",
            "theta", "student")]
        leaves += [c for layer in caches["layers"]
                   for c in layer["attn"].values()]
        sigs.add(tuple((tuple(x.shape), x.dtype, x.data_ptr())
                       for x in leaves))
        calls.append(1)
        return real(params, rp, tok, caches, t, cfg, spec, mode=mode,
                    policy=policy, table=table, trash=trash)

    monkeypatch.setattr(serve_mod, "decode_step", recording)
    eng = _engine(s)
    got = _staggered(eng, GenRequest, prompts)
    assert len(sigs) == 1 and len(calls) == eng.timing["decode_steps"]
    monkeypatch.undo()
    ring = [_ring_solo(s, p, 6, b) for p, b in zip(prompts, BUDGETS)]
    assert got == ring


def test_budget_one_rows_equal_a_base_paged_engine(setup):
    s = setup
    prompts = _prompts(s, 0, LENS)
    elastic = _staggered(_engine(s), GenRequest, prompts)
    base = _engine(s, mode="base").generate(
        [GenRequest(p, 6) for p in prompts])
    for i, b in enumerate(BUDGETS):
        if b == 1.0:
            assert elastic[i] == list(base[i])
    assert any(elastic[i] != list(base[i]) for i, b in enumerate(BUDGETS)
               if b is not None and b < 1.0)


def test_prefix_sharing_refcounts_and_parity(setup):
    """Two live requests with a common 16-token prefix share its 2 full
    pages; outputs match solo ring runs; the pool drains; different
    budgets do not share."""
    s = setup
    rng = np.random.default_rng(1)
    V = s["tcfg"].vocab_size
    pre = rng.integers(0, V, 16).astype(np.int32)
    a = np.concatenate([pre, rng.integers(0, V, 4).astype(np.int32)])
    b = np.concatenate([pre, rng.integers(0, V, 4).astype(np.int32)])
    eng = _engine(s)
    h1 = eng.submit(GenRequest(a, 4, budget=0.5))
    eng.step()
    h2 = eng.submit(GenRequest(b, 4, budget=0.5))
    eng.step()
    assert eng.paged_stats()["shared"] == 2
    _drain(eng, [h1, h2])
    assert list(h1.output) == _ring_solo(s, a, 4, 0.5)
    assert list(h2.output) == _ring_solo(s, b, 4, 0.5)
    assert eng.paged_stats()["allocated"] == 0
    h3 = eng.submit(GenRequest(a, 2, budget=0.5))
    eng.step()
    h4 = eng.submit(GenRequest(a, 2, budget=1.0))
    eng.step()
    assert eng.paged_stats()["shared"] == 0
    _drain(eng, [h3, h4])
    assert eng.paged_stats()["allocated"] == 0


def test_cancel_returns_shared_pages(setup):
    s = setup
    p = np.random.default_rng(2).integers(0, s["tcfg"].vocab_size,
                                          20).astype(np.int32)
    eng = _engine(s)
    h1 = eng.submit(GenRequest(p, 8, budget=0.5))
    eng.step()
    h2 = eng.submit(GenRequest(p, 8, budget=0.5))
    eng.step()
    assert eng.paged_stats()["shared"] == 2
    assert eng.cancel(h1)
    assert eng.paged_stats()["shared"] == 0     # h2 still holds them
    assert eng.paged_stats()["allocated"] > 0
    assert eng.cancel(h2)
    assert eng.paged_stats()["allocated"] == 0
    assert not eng.has_work


@pytest.mark.parametrize("steps", [4, 5])
def test_fork_child_equals_an_independent_run(setup, steps):
    """fork() mid-decode (4 steps: a partial tail page of 7 lanes, copied;
    5 steps: a page-aligned tail, a blank page) shares the full pages, and
    the child emits exactly what an independent request with prompt +
    parent output so far emits; the parent continues the same way."""
    s = setup
    p = np.random.default_rng(3).integers(0, s["tcfg"].vocab_size,
                                          11).astype(np.int32)
    eng = _engine(s)
    hp = eng.submit(GenRequest(p, 10, budget=0.7))
    for _ in range(steps):
        eng.step()
    prefix = list(hp.output)
    assert 0 < len(prefix) < 10
    assert eng._t[hp.slot] % PS == (7 if steps == 4 else 0)
    hc = eng.fork(hp)
    assert eng.paged_stats()["shared"] == eng._t[hp.slot] // PS
    _drain(eng, [hp, hc])
    indep = _ring_solo(s, np.concatenate([p, np.asarray(prefix, np.int32)]),
                       10 - len(prefix), 0.7)
    assert list(hc.output) == indep
    assert list(hp.output[len(prefix):]) == indep
    assert eng.paged_stats()["allocated"] == 0
    with pytest.raises(ValueError, match="running"):
        eng.fork(hp)


def test_preemption_by_page_pressure_resumes_exactly(setup):
    """A pool of 9 pages (8 usable) for two requests that need 5 each at
    full length: both start, collide as they grow, the later one is
    evicted and re-queued as a continuation, and both still emit their
    solo-run tokens."""
    s = setup
    prompts = _prompts(s, 4, (24, 24))
    oracle = [_ring_solo(s, p, 10, 0.8) for p in prompts]
    eng = _engine(s, n_pages=9)
    handles = [eng.submit(GenRequest(p, 10, budget=0.8)) for p in prompts]
    steps = 0
    while not all(h.done for h in handles):
        assert eng.step() > 0, "stalled"
        steps += 1
        assert steps < 200
    assert eng.n_preempted >= 1
    assert [list(h.output) for h in handles] == oracle
    assert eng.paged_stats()["allocated"] == 0


def test_paged_validation(setup):
    s = setup
    moe = dataclasses.replace(s["tspec"], mlp_n_experts=4,
                              expert_routed=True)
    with pytest.raises(ValueError, match="dense MLP"):
        ServingEngine(s["tparams"], s["trp"], s["tcfg"], moe, mode="infer",
                      batch_size=2, max_seq=32, kv_layout="paged",
                      device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        _engine(s, kv_layout="blocked")
    with pytest.raises(ValueError, match="infer/base"):
        _engine(s, mode="train")
    eng = _engine(s, n_pages=4)                 # 3 usable + 1 trash
    with pytest.raises(ValueError, match="pages"):
        eng.submit(GenRequest(np.arange(30, dtype=np.int32), 2))
    with pytest.raises(ValueError, match="paged"):
        _engine(s, kv_layout="ring").fork(None)
