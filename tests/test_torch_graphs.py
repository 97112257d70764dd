"""The serving engine's compiled entry points, on the CPU at toy-lm size
(f32, 2 layers): what a CUDA graph of the decode step and of the paged
prefill chunk needs, checked where no card is.

* ``compile_counts()`` stays flat, as the JAX engine's does, on the stream
  that ``tests/test_pagedkv.py`` and ``tests/test_serving.py`` put to JAX:
  budgets {None, 1.0, 0.75, 0.5}, temperatures {0, 0.7}, top-k {0, 40},
  seeds, staggered admissions, and (paged) a fork and a preemption. JAX
  builds {prefill 1, decode 1}; the port one chunk form (a paged engine)
  and two decode forms, greedy-only and sampling.
* Every tensor the decode body and the chunk body read or write keeps its
  storage (``data_ptr``) across steps, admissions, forks and preemptions:
  the precondition of replaying a captured graph.
* ``prefill_chunk_step`` with 0-d tensor ``write_page``/``pos0``/``plen``
  equals the int-argument call bit for bit, and JAX's chunk within
  ``tests/test_torch_paged.py``'s f32 tolerance.
* ``ElasticPolicy.set_row_`` equals ``set_row`` and keeps every leaf's
  storage.

JAX runs its kernels' plain versions here (``kernel_backend="ref"``; the
counts do not depend on it) or Pallas in interpret mode (the chunk).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.models.model import prefill_chunk_step as jax_chunk  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.core.policy import ElasticPolicy  # noqa: E402
from repro_torch.models import prefill_chunk_step  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402
from tests.test_torch_interop import toy_pair  # noqa: E402
from tests.test_torch_paged import TOL, _check_pools, _filled_pools  # noqa: E402

BATCH, MAX_SEQ, PS = 2, 64, 8
N_HEADS = 4


@pytest.fixture(scope="module")
def setup():
    return toy_pair(seed=0)


def _engines(s, layout, n_pages=None):
    """The port's engine and the JAX engine (plain versions) of one
    layout on the same weights."""
    kw = dict(kv_layout="paged", page_size=PS, n_pages=n_pages) \
        if layout == "paged" else {}
    jspec = dataclasses.replace(s["jspec"], kernel_backend="ref")
    return (ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                          mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
                          device="cpu", **kw),
            JaxEngine(s["params"], s["rp"], s["jcfg"], jspec, mode="infer",
                      batch_size=BATCH, max_seq=MAX_SEQ, **kw))


def _drain(eng, handles):
    steps = 0
    while not all(h.done for h in handles):
        assert eng.step() > 0, "engine stalled"
        steps += 1
        assert steps < 300


def _stream(eng, make_req, layout, V, after_first=None):
    """Budgets {None, 1.0, 0.75, 0.5}, temperatures {0, 0.7}, top-k {0,
    40}, seeds, admitted staggered (greedy-only and sampling steps both
    run); then two more requests at other settings (ring), or a fork
    mid-page with a new seed and two 24-token requests that collide on the
    9-page pool, a preemption (paged). The ring stream's prompts share one
    length (the JAX ring compiles its one-shot prefill per prompt length).
    ``after_first(eng)`` runs after the first staggered batch drains."""
    rng = np.random.default_rng(5)
    lens = (5, 13, 16, 21) if layout == "paged" else (8,) * 4
    prompt = lambda n: rng.integers(0, V, n).astype(np.int32)
    knobs = [dict(budget=None), dict(budget=1.0, temperature=0.7, top_k=40,
                                     seed=3),
             dict(budget=0.75), dict(budget=0.5, temperature=0.7, seed=11)]
    reqs = [make_req(prompt(n), new, **k)
            for n, new, k in zip(lens, (8, 3, 6, 3), knobs)]
    hs = [eng.submit(reqs[0]), eng.submit(reqs[1])]
    eng.step()
    eng.step()
    hs += [eng.submit(r) for r in reqs[2:]]
    _drain(eng, hs)
    if after_first is not None:
        after_first(eng)
    if layout == "ring":
        _drain(eng, [eng.submit(make_req(prompt(8), 5, budget=b, **k))
                     for b, k in ((0.5, dict(temperature=0.7, top_k=40,
                                             seed=9)), (0.75, {}))])
        return
    hp = eng.submit(make_req(prompt(11), 8, budget=0.5, temperature=0.7,
                             seed=5))
    for _ in range(4):
        eng.step()
    hc = eng.fork(hp, seed=6)
    _drain(eng, [hp, hc])
    _drain(eng, [eng.submit(make_req(prompt(24), 10, budget=b))
                 for b in (0.75, None)])


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_compile_counts_stay_flat_beside_jax(setup, layout):
    s = setup
    V = s["tcfg"].vocab_size
    port, jeng = _engines(s, layout, n_pages=9 if layout == "paged" else None)
    first = {}
    _stream(port, GenRequest, layout, V,
            after_first=lambda e: first.update(e.compile_counts()))
    _stream(jeng, JaxRequest, layout, V)
    want = {"prefill": 1 if layout == "paged" else 0, "decode": 2}
    assert first == want
    assert port.compile_counts() == want
    assert jeng.compile_counts() == {"prefill": 1, "decode": 1}
    if layout == "paged":
        assert port.n_preempted >= 1
        assert port.paged_stats()["allocated"] == 0


def _leaves(obj):
    """Every tensor in ``obj`` (tuples, lists, dicts and dataclasses such
    as the policy, in order)."""
    if torch.is_tensor(obj):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    elif not isinstance(obj, (list, tuple)):
        return []
    return [x for o in obj for x in _leaves(o)]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_step_storage_never_moves(setup, monkeypatch, layout):
    """What the decode body hands ``decode_step`` and ``sample_tokens``
    (but the positions t + 1 it computes) and what the chunk body hands
    ``prefill_chunk_step`` keep their shapes, dtypes and storage through
    the stream's admissions, sampling and greedy steps, fork and
    preemption; so do the token buffer and the chunk's logits."""
    s = setup
    calls = {"decode": set(), "sample": set(), "chunk": set()}
    n = {"decode": 0}
    sig = lambda obj: tuple((tuple(x.shape), x.dtype, x.data_ptr())
                            for x in _leaves(obj))
    real_step, real_sample = serve_mod.decode_step, serve_mod.sample_tokens
    real_chunk = serve_mod.prefill_chunk_step

    def step(*a, **kw):
        calls["decode"].add(sig((a[2:], kw)))     # params are static
        n["decode"] += 1
        return real_step(*a, **kw)

    def sample(logits, *knobs):
        if knobs and knobs[0].shape == (BATCH,):   # not the first token's
            calls["sample"].add(sig(knobs[:3]))
        return real_sample(logits, *knobs)

    def chunk(*a, **kw):
        calls["chunk"].add(sig((a[2:], kw)))
        return real_chunk(*a, **kw)
    monkeypatch.setattr(serve_mod, "decode_step", step)
    monkeypatch.setattr(serve_mod, "sample_tokens", sample)
    monkeypatch.setattr(serve_mod, "prefill_chunk_step", chunk)
    eng, _ = _engines(s, layout, n_pages=9 if layout == "paged" else None)
    fixed = [eng._tok.data_ptr()] + ([eng._chunk_logits.data_ptr()]
                                     if layout == "paged" else [])
    _stream(eng, GenRequest, layout, s["tcfg"].vocab_size)
    assert len(calls["decode"]) == 1 and len(calls["sample"]) == 1
    assert n["decode"] == eng.timing["decode_steps"]   # one call a step
    assert len(calls["chunk"]) == (1 if layout == "paged" else 0)
    assert fixed == [eng._tok.data_ptr()] + ([eng._chunk_logits.data_ptr()]
                                             if layout == "paged" else [])


def test_tensor_chunk_arguments_equal_ints_and_jax(setup):
    """A final chunk with padding (5 real tokens of 8, write page 1, the
    table row [5, 8, 1]) with 0-d tensor write_page/pos0/plen: the same
    logits and pools as the int-argument call bit for bit, and JAX's
    within f32 1e-5."""
    s = setup
    tree, tc_int = _filled_pools(s, 12, 1)
    _, tc_t = _filled_pools(s, 12, 1)
    jc = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(2)
    row = np.asarray([5, 8, 1, -1, -1, -1, -1, -1], np.int32)
    pos0, plen = 16, 21
    tok = np.zeros((1, PS), np.int32)
    tok[0, :plen - pos0] = rng.integers(0, s["tcfg"].vocab_size, plen - pos0)
    tp = ElasticPolicy.uniform(0.5, n_heads=N_HEADS)
    args = (s["tparams"], s["trp"], torch.from_numpy(tok))
    li, tc_int = prefill_chunk_step(*args, tc_int, 1, torch.from_numpy(row),
                                    pos0, plen, s["tcfg"], s["tspec"],
                                    mode="infer", policy=tp)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    lt, tc_t = prefill_chunk_step(*args, tc_t, i32(1), torch.from_numpy(row),
                                  i32(pos0), i32(plen), s["tcfg"], s["tspec"],
                                  mode="infer", policy=tp)
    assert torch.equal(lt, li)
    for a, b in zip(_leaves(tc_t), _leaves(tc_int)):
        assert torch.equal(a, b)
    jl, jc = jax_chunk(s["params"], s["rp"], jnp.asarray(tok), jc,
                       jnp.int32(1), jnp.asarray(row), jnp.int32(pos0),
                       jnp.int32(plen), s["jcfg"], s["jspec"], mode="infer",
                       policy=JaxPolicy.uniform(0.5, n_heads=N_HEADS))
    np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **TOL)
    _check_pools(tree, jc, tc_t)


@pytest.mark.parametrize("rows", ["(B,)", "(L, B)"])
def test_set_row_in_place_equals_set_row(rows):
    """The engine's in-place splice gives the functional splice's values
    and keeps every leaf's storage: (B,) leaves take a solved budget's
    scalar row, (L, B) schedules a per-layer (L, 1) row."""
    B, L = 4, 3
    live = ElasticPolicy.uniform(1.0).broadcast_rows(B)
    row = ElasticPolicy.uniform(0.5, n_heads=N_HEADS)
    if rows == "(L, B)":
        live = ElasticPolicy(**{f.name: getattr(live, f.name).expand(
            L, B).clone() for f in dataclasses.fields(live)})
        row = ElasticPolicy(**{f.name: torch.linspace(
            0.25, 0.75, L)[:, None] * getattr(row, f.name)
            for f in dataclasses.fields(row)})
    before = [x.clone() for x in _leaves(live)]
    ptrs = [x.data_ptr() for x in _leaves(live)]
    want = live.set_row(2, row)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(live), before))
    assert live.set_row_(2, row) is live
    assert [x.data_ptr() for x in _leaves(live)] == ptrs
    for g, w, b, r in zip(_leaves(live), _leaves(want), before,
                          _leaves(row)):
        assert torch.equal(g, w)
        assert torch.equal(g[..., 2], r.reshape(g[..., 2].shape))
        assert torch.equal(g[..., [0, 1, 3]], b[..., [0, 1, 3]])
