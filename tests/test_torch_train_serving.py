"""Train-mode (top-k) serving of the port's ring engine against the JAX
package's, at toy size, seeded with numpy.

``ServingEngine(mode="train")`` admits each request with the top-k routing
of training: one ``RoutingPlan`` per block in the request's static ragged
capacity bucket (``policy.ragged_bucket``), the plan's k/v scattered back
to their positions for the ring, and, through the plan, the dense MLPs in
the routed MLP (``fused_mlp_routed``; with int8 weights its scale
operands). Decode is the threshold step of every mode. JAX runs its Pallas
kernels in interpret mode (its ``ROUTED_MLP_SLAB_BYTES`` gate sends the toy
shapes to its ``fused_mlp_routed`` kernel), the port its kernels' plain
versions (CPU tensors). Held to JAX, the same weights carried over by
``interop``:
  * test_ragged.py's own case (toy-lm with four moefied experts, budgets
    0.3 / 0.35 / 0.8 at once) and a staggered dense toy workload in f32,
    int8 (weights and K/V) and bf16, and with depth routed: greedy tokens
    equal; every admission's bucket equals JAX's, at most
    ``RAGGED_N_BUCKETS`` per prompt length; the logits of every admission
    and decode step within 1e-5 (f32), 1e-3 (int8) or 1e-2 (bf16:
    ``tests/test_torch_quant.py``'s tolerances); the final ring caches
    within 1e-5 (f32; ``valid`` and ``pos`` equal), int8 codes within one
    step and scales within 1e-5, bf16 within 2e-2;
  * a train-mode prefill per (prompt, budget), f32 and int8: logits and
    the ring cache (k, v, valid, pos) at the same tolerances.
The port's own, bit for bit: staggered == solo, budget 1.0 == the
``mode="base"`` engine (int8: the int8 one), and ``compile_counts()`` at
{prefill 0, decode 1} with one decode-step signature across budgets and
buckets. Routing decisions are held equal by seeds whose router logits
clear their thresholds, head weights their top-k and plan scores their
bucket's top-k by more than 1e-4 (asserted).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import quant as JQ  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training import serve as jax_serve  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.core.routing import IDENTITY_BUCKET, RAGGED_N_BUCKETS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import prefill  # noqa: E402
from repro_torch.models import quant as Q  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402
from tests.test_torch_interop import SPEC_KW, RouterMargins, toy_pair  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = {"fp32": TOL, "int8": dict(rtol=1e-3, atol=1e-3),
             "bf16": dict(rtol=1e-2, atol=1e-2)}
SPECS = {"dense": SPEC_KW,
         "experts": dict(SPEC_KW, mlp_n_experts=4, expert_routed=True),
         "depth": dict(SPEC_KW, depth_routed=True)}
# tests/test_ragged.py:233-254: three 8-token prompts admitted at once
RAGGED = dict(batch=4, max_seq=24, new=4, lens=(8, 8, 8),
              budgets=(0.3, 0.35, 0.8), stagger=False)
# two requests, two steps, the rest: admissions land mid-decode
STAGGERED = dict(batch=3, max_seq=40, new=6, lens=(8, 13, 16, 11, 13),
                 budgets=(1.0, 0.5, 0.3, 0.75, 0.5), stagger=True)
GRID = [("experts", "fp32", RAGGED), ("dense", "fp32", STAGGERED),
        ("dense", "int8", STAGGERED), ("dense", "bf16", STAGGERED),
        ("depth", "fp32", STAGGERED)]
IDS = [f"{c}-{d}" for c, d, _ in GRID]


def _np(t):
    return t.detach().cpu().numpy()


class TopkMargins:
    """Records, while installed, the gap between the k-th and (k+1)-th
    largest router score of every plan the port builds (k the plan's
    count, per row). JAX and the port agree to ~1e-6 on these scores, so
    a gap well above that means both select the same tokens."""

    def __init__(self, monkeypatch):
        self.gap = np.inf
        real = R.make_plan

        def make_plan(scores, k, bucket):
            plan = real(scores, k, bucket)
            B, S = scores.shape
            cnt = torch.as_tensor(plan.count).reshape(-1).expand(B).long()
            inner = cnt < S
            if inner.any():
                srt = torch.sort(scores, dim=-1, descending=True).values
                rows = torch.arange(B)
                gap = srt[rows, cnt - 1] - srt[rows, cnt.clamp(max=S - 1)]
                self.gap = min(self.gap, float(gap[inner].min()))
            return plan
        monkeypatch.setattr(R, "make_plan", make_plan)

    def check(self, margin=1e-4):
        assert self.gap > margin, f"a plan's top-k gap is {self.gap}"


@functools.lru_cache(maxsize=None)
def pair(case):
    return toy_pair(seed=0, spec_kw=SPECS[case])


def prompts(s, w, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, s["tcfg"].vocab_size, n).astype(np.int32)
            for n in w["lens"]]


def serve(eng, make_req, ps, w, budgets=None):
    """Greedy tokens of the workload ``w`` (``budgets`` overrides its
    budgets)."""
    budgets = w["budgets"] if budgets is None else budgets
    reqs = [make_req(p, w["new"], budget=b) for p, b in zip(ps, budgets)]
    first = 2 if w["stagger"] else len(reqs)
    hs = [eng.submit(r) for r in reqs[:first]]
    if w["stagger"]:
        for _ in range(2):
            eng.step()
        hs += [eng.submit(r) for r in reqs[first:]]
    while not all(h.done for h in hs):
        assert eng.step() > 0, "engine stalled"
    return [[int(x) for x in h.output] for h in hs]


def engine(s, w, dtype="fp32", mode="train", batch=None):
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=batch or w["batch"],
                         max_seq=w["max_seq"], kv_dtype=dtype,
                         weight_dtype=dtype, device="cpu")


def _recording(rec, key, real):
    """``real`` wrapped: each call's (prompt length, result) into
    rec[key] (a bucket solver)."""
    def wrap(pol, s, **kw):
        out = real(pol, s, **kw)
        rec[key].append((s, out))
        return out
    return wrap


@pytest.fixture(scope="module")
def engine_runs():
    """Each case of GRID served by JAX and by the port in train mode, with
    every sampled row's logits (admissions (1, V), decode steps (B, V)),
    every admission's ragged bucket, both engines' final caches and
    ``compile_counts()``, the port's decode-step signatures and its calls
    of ``ops.fused_mlp_routed`` recorded."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        rec = {}

        def jst(logits, *a, _real=jax_serve.sample_tokens, **kw):
            jax.debug.callback(lambda lg: rec["jax"].append(np.array(lg)),
                               logits, ordered=True)
            return _real(logits, *a, **kw)

        def tst(logits, *a, _real=serve_mod.sample_tokens, **kw):
            rec["port"].append(_np(logits).copy())
            return _real(logits, *a, **kw)

        def decode(params, rp, tok, caches, t, cfg, spec, mode, policy,
                   _real=serve_mod.decode_step):
            leaves = [tok, t] + [getattr(policy, f.name) for f in
                                 dataclasses.fields(policy)]
            leaves += [c for layer in caches["layers"]
                       for c in layer["attn"].values()]
            rec["sigs"].add(tuple((tuple(x.shape), x.dtype, x.data_ptr())
                                  for x in leaves))
            return _real(params, rp, tok, caches, t, cfg, spec, mode=mode,
                         policy=policy)

        def routed(*a, _real=ops.fused_mlp_routed, **kw):
            rec["routed"].append(kw.get("wi_scale") is not None)
            return _real(*a, **kw)

        mp.setattr(jax_serve, "sample_tokens", jst)
        mp.setattr(serve_mod, "sample_tokens", tst)
        mp.setattr(jax_serve, "ragged_bucket", _recording(
            rec, "jax_buckets", jax_serve.ragged_bucket))
        mp.setattr(serve_mod, "ragged_bucket", _recording(
            rec, "port_buckets", serve_mod.ragged_bucket))
        mp.setattr(serve_mod, "decode_step", decode)
        mp.setattr(ops, "fused_mlp_routed", routed)
        for case, dtype, w in GRID:
            rec.update(jax=[], port=[], jax_buckets=[], port_buckets=[],
                       sigs=set(), routed=[])
            s = pair(case)
            ps = prompts(s, w)
            jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                             mode="train", batch_size=w["batch"],
                             max_seq=w["max_seq"], kv_dtype=dtype,
                             weight_dtype=dtype)
            want = serve(jeng, JaxRequest, ps, w)
            jax.effects_barrier()
            with pytest.MonkeyPatch.context() as probes:
                margins, topk = RouterMargins(probes), TopkMargins(probes)
                teng = engine(s, w, dtype)
                got = serve(teng, GenRequest, ps, w)
            out[(case, dtype)] = dict(
                want=want, got=got, margins=(margins.token, margins.head,
                                             topk.gap),
                jax_logits=rec["jax"], port_logits=rec["port"],
                jax_buckets=rec["jax_buckets"],
                port_buckets=rec["port_buckets"],
                jax_counts=jeng.compile_counts(),
                port_counts=teng.compile_counts(),
                jax_caches=jax.tree.map(np.asarray, jeng._caches),
                port_caches=teng._caches, sigs=len(rec["sigs"]),
                routed=list(rec["routed"]))
    return out


def _check_caches(jtree, tc, dtype):
    """The port's ring caches against JAX's, layer by layer: k and v
    within 1e-5 (f32) or 2e-2 (bf16), int8 codes within 1 and scales
    within 1e-5, ``valid`` and ``pos`` equal. Returns the number of int8
    codes one step apart."""
    n_diff = 0
    for i, layer in enumerate(tc["layers"]):
        ja = jax.tree.map(lambda a: np.asarray(a[i]), jtree["scan"][0])
        for name, leaf in layer["attn"].items():
            want = ja["attn"][name]
            if name in ("valid", "pos"):
                np.testing.assert_array_equal(_np(leaf), want)
            elif dtype == "int8" and name in ("k", "v"):
                d = np.abs(_np(leaf).astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1, f"layer {i} {name}: codes {d.max()} apart"
                n_diff += int((d > 0).sum())
            elif dtype == "bf16":
                assert leaf.dtype == torch.bfloat16
                np.testing.assert_allclose(_np(leaf.float()),
                                           np.asarray(want, np.float32),
                                           rtol=2e-2, atol=2e-2)
            else:
                np.testing.assert_allclose(_np(leaf), want, **TOL)
    return n_diff


@pytest.mark.parametrize("case,dtype,w", GRID, ids=IDS)
def test_engine_matches_jax_engine(engine_runs, case, dtype, w):
    run = engine_runs[(case, dtype)]
    assert min(run["margins"]) > 1e-4, f"margins {run['margins']}"
    assert run["got"] == run["want"]
    # the same bucket at every admission, at most RAGGED_N_BUCKETS per
    # prompt length, and at least one a real plan (the routed path ran)
    assert run["port_buckets"] == run["jax_buckets"]
    assert len(run["port_buckets"]) == len(w["lens"])
    for n in set(w["lens"]):
        real = {b for m, b in run["port_buckets"] if m == n
                and b is not None and b != IDENTITY_BUCKET}
        assert len(real) <= RAGGED_N_BUCKETS
    assert any(b is not None and b != IDENTITY_BUCKET and b < m
               for m, b in run["port_buckets"])
    # sampled rows: admissions (1, V) in order, then decode steps (B, V)
    assert len(run["port_logits"]) == len(run["jax_logits"]) > len(w["lens"])
    worst = 0.0
    for a, b in zip(run["jax_logits"], run["port_logits"]):
        np.testing.assert_allclose(b, a, **LOGIT_TOL[dtype])
        worst = max(worst, float(np.abs(b - a).max()))
    n = _check_caches(run["jax_caches"], run["port_caches"], dtype)
    # the port's ring admission is eager; one decode form, one signature
    assert run["port_counts"] == {"prefill": 0, "decode": 1}
    assert run["jax_counts"]["decode"] == 1
    assert run["sigs"] == 1
    if case == "experts":       # moefied MLPs: the bucket buffer, moe_gmm
        assert run["routed"] == []
    else:                       # a routed MLP per layer of each plan
        assert run["routed"] and all(q == (dtype == "int8")
                                     for q in run["routed"])
    print(f"{case} {dtype}: buckets {run['port_buckets']}, largest logit "
          f"difference {worst:.3e}, {n} int8 codes one step from JAX's, "
          f"JAX {run['jax_counts']}")


@pytest.mark.parametrize("case,dtype,w", GRID, ids=IDS)
def test_staggered_equals_solo(engine_runs, case, dtype, w):
    """Each partial-budget request served alone gives its mixed-run tokens
    (its plan, bucket and routed rows depend on it alone)."""
    s = pair(case)
    ps = prompts(s, w)
    mixed = engine_runs[(case, dtype)]["got"]
    solo_w = dict(w, stagger=False)
    for i in [i for i, b in enumerate(w["budgets"]) if b < 1.0][:2]:
        b = w["budgets"][i]
        solo = serve(engine(s, w, dtype), GenRequest, [ps[i]], solo_w,
                     budgets=[b])[0]
        assert solo == mixed[i], f"request {i} (budget {b})"


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_budget_one_equals_the_base_engine(engine_runs, dtype):
    """Budget 1.0 takes the identity bucket at admission and the full gates
    in decode: the teacher's tokens bit for bit (int8: the int8 teacher),
    in a mixed-budget staggered run."""
    s, w = pair("dense"), STAGGERED
    base = serve(engine(s, w, dtype, mode="base"), GenRequest, prompts(s, w),
                 w, budgets=[None] * len(w["budgets"]))
    run = engine_runs[("dense", dtype)]
    full = [i for i, b in enumerate(w["budgets"]) if b == 1.0]
    assert full and all(run["got"][i] == base[i] for i in full)
    assert all((w["lens"][i], IDENTITY_BUCKET) in run["port_buckets"]
               for i in full)
    assert any(run["got"][i] != base[i] for i, b in
               enumerate(w["budgets"]) if b < 1.0)


def test_decode_forms_stay_flat_across_budgets(monkeypatch):
    """Many budgets and prompt lengths (several buckets each, the identity
    bucket among them) through one train-mode engine: one decode form and
    one decode-step signature, no prefill form (the admission is eager)."""
    s, w = pair("dense"), STAGGERED
    rng = np.random.default_rng(11)
    lens = (6, 9, 14, 17, 20, 9)
    budgets = (1.0, 0.9, 0.6, 0.45, 0.25, 0.15)
    ps = [rng.integers(0, s["tcfg"].vocab_size, n).astype(np.int32)
          for n in lens]
    buckets, sigs = [], set()
    real_b, real_d = serve_mod.ragged_bucket, serve_mod.decode_step

    def bucket(pol, n, **kw):
        buckets.append(real_b(pol, n, **kw))
        return buckets[-1]

    def decode(params, rp, tok, caches, t, cfg, spec, mode, policy):
        leaves = [tok, t] + [getattr(policy, f.name) for f in
                             dataclasses.fields(policy)]
        leaves += [c for layer in caches["layers"]
                   for c in layer["attn"].values()]
        sigs.add(tuple((tuple(x.shape), x.dtype) for x in leaves))
        return real_d(params, rp, tok, caches, t, cfg, spec, mode=mode,
                      policy=policy)
    monkeypatch.setattr(serve_mod, "ragged_bucket", bucket)
    monkeypatch.setattr(serve_mod, "decode_step", decode)
    eng = engine(s, w)
    serve(eng, GenRequest, ps, dict(w, lens=lens), budgets=budgets)
    assert len(set(buckets)) >= 4 and IDENTITY_BUCKET in buckets
    assert eng.compile_counts() == {"prefill": 0, "decode": 1}
    assert len(sigs) == 1


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("budget", [0.5, 0.3])
def test_train_prefill_caches_match_jax(monkeypatch, dtype, budget):
    """One train-mode prefill per (prompt, budget) at a ring length past
    the prompt, the bucket solved by both solvers (equal): last-token
    logits within 1e-5 (int8 1e-3) and the ring caches, the plan's k/v at
    their positions (the unselected positions' rows are the plan tail's,
    held ``valid`` False), as ``_check_caches``."""
    from repro.core.policy import ragged_bucket as jax_ragged_bucket
    from repro.core.policy import solve_budget as jax_solve
    from repro_torch.core.policy import ragged_bucket, solve_budget
    s = pair("dense")
    jparams, jspec, tparams, tspec = s["params"], s["jspec"], \
        s["tparams"], s["tspec"]
    if dtype == "int8":
        jparams = JQ.quantize_params_tree(jparams, "int8")
        tparams = Q.quantize_params_tree(tparams, "int8")
        jspec = dataclasses.replace(jspec, kv_dtype="int8",
                                    weight_dtype="int8")
        tspec = dataclasses.replace(tspec, kv_dtype="int8",
                                    weight_dtype="int8")
    margins, topk = RouterMargins(monkeypatch), TopkMargins(monkeypatch)
    tok = np.random.default_rng(4).integers(
        0, s["tcfg"].vocab_size, (1, 14)).astype(np.int32)
    jp = jax_solve(s["jcfg"], jspec, budget, static=True)
    tp = solve_budget(s["tcfg"], tspec, budget, static=True)
    jb = jax_ragged_bucket(jp, 14, spec=jspec)
    tb = ragged_bucket(tp, 14, spec=tspec)
    assert tb == jb and tb not in (None, IDENTITY_BUCKET) and tb < 14
    jl, jc = jax_prefill(jparams, s["rp"], {"tokens": jnp.asarray(tok)},
                         s["jcfg"], jspec, mode="train", max_cache_len=24,
                         policy=jax.tree.map(jnp.asarray, jp), bucket=jb)
    tl, tc = prefill(tparams, s["trp"], {"tokens": torch.from_numpy(tok)},
                     s["tcfg"], tspec, mode="train", max_cache_len=24,
                     policy=tp, bucket=tb)
    topk.check()
    margins.check()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL[dtype])
    _check_caches(jax.tree.map(np.asarray, jc), tc, dtype)
    # the plan dropped tokens: unselected positions hold no valid K/V
    assert not bool(tc["layers"][0]["attn"]["valid"][0, :14].all())
