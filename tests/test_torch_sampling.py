"""Seeded sampling of the port against the JAX package, on the CPU in f32.

* ``core/prng.py``: ``PRNGKey``, ``fold_in``, the 32-bit random bits and
  the uniforms equal ``jax.random``'s bit for bit (threefry2x32 with the
  partitionable counter layout, asserted to be JAX's setting), over edge
  seeds and positions. The gumbel noise: each of its two logarithms within
  1 ulp of XLA's on the same input (the composition -log(-log u)
  magnifies a 1-ulp difference of the inner log near g = 0, so the
  composed noise is held to 4 f32 epsilons of max(1, |g|)).
* ``sample_tokens`` equal to JAX's on seeded logits, every row mixing
  temperature, top-k, seed and position; temperature-0 rows equal the
  argmax.
* The port's engine against the JAX engine on a staggered mixed-budget,
  mixed-temperature workload (ring and paged): tokens equal. Inside the
  port: the same seed gives the same stream, temperature-0 rows equal a
  greedy run, a fork with the parent's seed continues the parent's stream
  and a preempted request resumes exactly.

Routing decisions are held equal by seeds whose router logits clear their
thresholds by more than 1e-4 (asserted).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training.serve import sample_tokens as jax_sample  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training.serve import sample_tokens  # noqa: E402
from tests.test_torch_interop import RouterMargins, toy_pair  # noqa: E402

SEEDS = [0, 1, 2 ** 31, 2 ** 32 - 1]
POSITIONS = [0, 7, 2 ** 16 + 3, 2 ** 31 - 1]
N = 4096


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.int32(pos))


def test_jax_runs_the_partitionable_threefry_layout():
    """The counter layout of ``random_bits`` depends on this flag; the
    port's copy is the partitionable one."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_equal_jax(seed):
    base = prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        base.numpy(), np.asarray(jax.random.PRNGKey(np.uint32(seed)),
                                 np.int64))
    for pos in POSITIONS:
        jk = _jax_key(seed, pos)
        tk = prng.fold_in(base, pos)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk, np.int64))
        np.testing.assert_array_equal(
            prng.random_bits(tk, N).numpy(),
            np.asarray(jax.random.bits(jk, (N,), jnp.uint32), np.int64))
        np.testing.assert_array_equal(
            prng.uniform(tk, N).numpy(),
            np.asarray(jax.random.uniform(jk, (N,), jnp.float32)))


def test_batched_keys_equal_one_at_a_time():
    """(B,) seeds and positions fold row by row, as the engine uses them."""
    seeds = torch.tensor(SEEDS, dtype=torch.int64)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    keys = prng.fold_in(prng.PRNGKey(seeds), pos)
    bits = prng.random_bits(keys, 64)
    for i, (s, p) in enumerate(zip(SEEDS, POSITIONS)):
        one = prng.fold_in(prng.PRNGKey(s), p)
        assert torch.equal(keys[i], one)
        assert torch.equal(bits[i], prng.random_bits(one, 64))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_per_logarithm(seed):
    tiny = np.finfo(np.float32).tiny
    for pos in POSITIONS[:2]:
        jk = _jax_key(seed, pos)
        tk = prng.fold_in(prng.PRNGKey(seed), pos)
        u = prng.uniform(tk, N, minval=tiny).numpy()
        np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(
            jk, (N,), jnp.float32, minval=tiny)))
        inner_j = np.asarray(-jnp.log(jnp.asarray(u)))
        inner_t = (-torch.log(torch.from_numpy(u))).numpy()
        assert _ulps(inner_t, inner_j).max() <= 1
        g_j = np.asarray(jax.random.gumbel(jk, (N,), jnp.float32))
        outer_t = (-torch.log(torch.from_numpy(inner_j.copy()))).numpy()
        assert _ulps(outer_t, g_j).max() <= 1
        g_t = prng.gumbel(tk, N).numpy()
        eps = np.finfo(np.float32).eps
        assert np.all(np.abs(g_t - g_j) <= 4 * eps * np.maximum(1.0,
                                                                np.abs(g_j)))


def test_sample_tokens_equal_jax():
    rng = np.random.default_rng(0)
    B, V = 12, 512
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3] * 3, np.float32)
    topk = np.array([0, 0, 0, 0, 3, 40, 3, 40, 1, V, V + 5, -1], np.int32)
    seeds = rng.integers(0, 2 ** 32, B, dtype=np.int64)
    pos = rng.integers(0, 4096, B).astype(np.int32)
    want = np.asarray(jax_sample(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(seeds.astype(np.uint32)), jnp.asarray(pos)))
    got = sample_tokens(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(topk), torch.from_numpy(seeds),
                        torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = logits.argmax(-1)
    assert np.array_equal(got[temp <= 0], greedy[temp <= 0])
    assert not np.array_equal(got, greedy)           # the others sampled
    # a top-1 row is its argmax at any temperature
    assert got[8] == greedy[8]
    assert np.array_equal(sample_tokens(torch.from_numpy(logits)).numpy(),
                          greedy)


# --------------------------------- engine ------------------------------------

BATCH, MAX_SEQ, PLEN, NEW, PS = 3, 40, 10, 8, 8
# (budget, temperature, top_k, seed): test_serving.py's mixed rows and more
ROWS = [(0.4, 0.0, 0, 0), (1.0, 0.7, 3, 9), (None, 1.0, 0, 2 ** 32 - 1),
        (0.75, 0.7, 40, 5), (0.5, 1.0, 3, 123456789)]


@pytest.fixture(scope="module")
def setup():
    s = toy_pair(seed=2)
    rng = np.random.default_rng(2)
    s["prompts"] = [rng.integers(0, s["tcfg"].vocab_size, PLEN,
                                 dtype=np.int64).astype(np.int32)
                    for _ in ROWS]
    return s


def _requests(make_req, prompts, rows, new=NEW):
    return [make_req(p, new, budget=b, temperature=t, top_k=k, seed=sd)
            for p, (b, t, k, sd) in zip(prompts, rows)]


def _staggered(engine, reqs):
    """Two requests, two steps, the rest: admissions land mid-decode."""
    handles = [engine.submit(r) for r in reqs[:2]]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(r) for r in reqs[2:]]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return [[int(x) for x in h.output] for h in handles]


def _port_engine(s, layout="ring", **kw):
    if layout == "paged":
        kw = dict(kv_layout="paged", page_size=PS, **kw)
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu", **kw)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_sampled_tokens_match_jax_engine(setup, monkeypatch, layout):
    s = setup
    jkw = dict(kv_layout="paged", page_size=PS) if layout == "paged" else {}
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ, **jkw)
    want = _staggered(jeng, _requests(JaxRequest, s["prompts"], ROWS))
    margins = RouterMargins(monkeypatch)
    got = _staggered(_port_engine(s, layout),
                     _requests(GenRequest, s["prompts"], ROWS))
    margins.check()
    assert got == want


def test_same_seed_same_stream_and_temperature_zero_is_greedy(setup):
    s = setup
    eng = _port_engine(s)
    prompt = s["prompts"][0]
    greedy = list(eng.generate([GenRequest(prompt, 6)])[0])
    r = GenRequest(prompt, 6, temperature=0.7, top_k=3, seed=42)
    a, b = (list(eng.generate([r])[0]) for _ in range(2))
    assert a == b
    assert list(eng.generate([GenRequest(prompt, 6, temperature=0.7, top_k=3,
                                         seed=43)])[0]) != a
    mixed = eng.generate([GenRequest(prompt, 6),
                          GenRequest(prompt, 6, temperature=1.2, seed=7)])
    assert list(mixed[0]) == greedy
    # staggered == solo with sampling on
    stag = _staggered(_port_engine(s), _requests(GenRequest, s["prompts"],
                                                 ROWS))
    for i in (1, 3, 4):
        solo = _port_engine(s).generate(
            _requests(GenRequest, s["prompts"][i:i + 1], ROWS[i:i + 1]))[0]
        assert list(solo) == stag[i]


def _signature(obj):
    """Shapes and dtypes of every tensor in ``obj`` (tuples, lists, dicts
    and dataclasses such as the policy walked in order)."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return ((tuple(obj.shape), obj.dtype),)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    elif not isinstance(obj, (list, tuple)):
        return ()
    return tuple(x for o in obj for x in _signature(o))


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_sampled_step_takes_the_greedy_step_tensors(setup, monkeypatch,
                                                    layout):
    """What a decode step hands ``decode_step`` has the same shapes and
    dtypes whether a live slot samples or not. The two forms differ by a
    host branch after it: a greedy-only step calls ``sample_tokens`` on the
    logits alone, a sampling step also hands it (B,) temperature, top-k,
    seed and position tensors, whatever the number of sampling slots."""
    from repro_torch.training import serve as serve_mod
    s = setup
    steps = []      # per decode step: [decode_step's, sample_tokens' tensors]
    real_step, real_sample = serve_mod.decode_step, serve_mod.sample_tokens

    def step(*a, **kw):
        steps.append([_signature((a, kw))])
        return real_step(*a, **kw)

    def sample(*a, **kw):
        if steps and len(steps[-1]) == 1:     # the decode step's own call
            steps[-1].append(_signature((a, kw)))
        return real_sample(*a, **kw)
    monkeypatch.setattr(serve_mod, "decode_step", step)
    monkeypatch.setattr(serve_mod, "sample_tokens", sample)
    eng = _port_engine(s, layout)
    _staggered(eng, [GenRequest(s["prompts"][0], 6),
                     GenRequest(s["prompts"][1], 6),
                     GenRequest(s["prompts"][2], 4, temperature=0.9,
                                seed=3)])
    greedy = [st for st in steps if len(st[1]) == 1]
    sampled = [st for st in steps if len(st[1]) > 1]
    assert greedy and sampled and len(greedy) + len(sampled) == len(steps)
    assert len({st[0] for st in steps}) == 1
    assert len({st[1] for st in sampled}) == 1
    logits, *knobs = sampled[0][1]
    assert logits == greedy[0][1][0]
    assert [shape for shape, _ in knobs] == [(BATCH,)] * 4


@pytest.mark.parametrize("steps", [4, 5])
def test_fork_with_the_parent_seed_continues_its_stream(setup, steps):
    s = setup
    p = s["prompts"][1]
    req = GenRequest(p, 10, budget=0.7, temperature=0.8, top_k=40, seed=77)
    eng = _port_engine(s, "paged")
    hp = eng.submit(req)
    for _ in range(steps):
        eng.step()
    prefix = list(hp.output)
    hc = eng.fork(hp)
    ho = eng.fork(hp, seed=78)
    while not all(h.done for h in (hp, hc, ho)):
        assert eng.step() > 0
    alone = list(_port_engine(s, "paged").generate([req])[0])
    assert list(hp.output) == alone
    assert prefix + list(hc.output) == alone
    indep = _port_engine(s).generate([GenRequest(
        np.concatenate([p, np.asarray(prefix, np.int32)]), 10 - len(prefix),
        budget=0.7, temperature=0.8, top_k=40, seed=78)])[0]
    assert list(ho.output) == list(indep)
    assert eng.paged_stats()["allocated"] == 0


def test_preempted_sampled_request_resumes_exactly(setup):
    s = setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, s["tcfg"].vocab_size, 24).astype(np.int32)
               for _ in range(2)]
    reqs = [GenRequest(p, 10, budget=0.8, temperature=0.9, seed=sd)
            for p, sd in zip(prompts, (11, 12))]
    oracle = [list(_port_engine(s).generate([r])[0]) for r in reqs]
    eng = _port_engine(s, "paged", n_pages=9)
    handles = [eng.submit(r) for r in reqs]
    steps = 0
    while not all(h.done for h in handles):
        assert eng.step() > 0
        steps += 1
        assert steps < 200
    assert eng.n_preempted >= 1
    assert [list(h.output) for h in handles] == oracle
