"""Depth routing (per-token whole-layer skip) of the port against the JAX
package, on the CPU in f32, and the port's own depth properties (the
counterparts of tests/test_depth.py:50-195).

toy-lm from ``toy_pair`` with ``depth_routed`` on both sides. JAX runs its
Pallas kernels in interpret mode (its jnp oracles for the moefied case, as
tests/test_torch_moe.py does), the port its kernels' plain versions (CPU
tensors). Held to JAX:
  * train-mode logits and the aux terms within rtol=atol=1e-5 at depth
    {1.0, 0.75, 0.5} x token {1.0, 0.5}, on the ragged plan path and on
    ``routing_impl="dense_mask"``; four spec variants (depth only; depth +
    the MLP token router; the serving slice's spec; depth + moefied
    experts) through the plan, dense and infer paths;
  * infer-mode logits, prefill caches (ring ``valid`` and ``pos`` equal
    exactly) and decode-step logits within 1e-5;
  * greedy tokens of the ring and paged engines: equal.
The port's own: budget 1.0 == the teacher bit for bit (train mode on the
identity bucket, engine decode); a partial depth at full token budget
plans a bucket; ragged == dense within 1e-4; mixed per-row depth budgets
== solo rows; staggered == solo with unchanged decode shapes on ring and
paged; FLOPs (``torch.utils.flop_counter``, the port's counterpart of the
JAX package's hloprof) monotone in depth and composing with the token
budget, the dense reference flat.

Routing decisions are held equal by seeds whose router logits clear their
thresholds by more than 1e-4 (asserted in the infer and engine cases).
The controller's live depth degrade (tests/test_depth.py:199) is held to
JAX in tests/test_torch_controller_serving.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import ragged_bucket as jax_ragged_bucket  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.core.policy import ElasticPolicy, ragged_bucket  # noqa: E402
from repro_torch.core.routing import IDENTITY_BUCKET  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402
from tests.test_torch_interop import SPEC_KW, RouterMargins, toy_pair  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
S, N_HEADS, N_EXP = 24, 4, 4
VARIANTS = {
    "depth": dict(mlp_token_routed=False, depth_routed=True),
    "depth+mlp": dict(mlp_token_routed=True, depth_routed=True),
    "slice": dict(SPEC_KW, depth_routed=True),
    "depth+experts": dict(SPEC_KW, depth_routed=True, mlp_n_experts=N_EXP,
                          expert_routed=True),
}


@functools.lru_cache(maxsize=None)
def pair(variant="slice", seed=0):
    s = toy_pair(seed=seed, spec_kw=VARIANTS[variant])
    if variant == "depth+experts":
        s["jspec"] = dataclasses.replace(s["jspec"], kernel_backend="ref")
    rng = np.random.default_rng(seed)
    s["tokens"] = rng.integers(0, s["tcfg"].vocab_size,
                               (2, S)).astype(np.int32)
    s["n_exp"] = N_EXP if "experts" in variant else None
    return s


def _policies(s, rows, tensor=True):
    """Per-row (token budget, depth budget) as a JAX and a port policy with
    (B,) leaves (``tensor``) or scalar leaves (one row)."""
    kw = dict(n_heads=N_HEADS, n_experts=s["n_exp"])
    jps = [JaxPolicy.uniform(t, **kw).replace(depth_capacity=d)
           for t, d in rows]
    tps = [ElasticPolicy.uniform(t, **kw).replace(depth_capacity=d)
           for t, d in rows]
    if tensor:
        return JaxPolicy.stack(jps), ElasticPolicy.stack(tps)
    return jax.tree.map(jnp.asarray, jps[0]), tps[0]


def _run_both(s, mode, jp, tp, impl="ragged", tokens=None):
    """Logits and aux of JAX and the port on the same tokens; the ragged
    bucket solved by both solvers (which must agree)."""
    jspec = dataclasses.replace(s["jspec"], routing_impl=impl)
    tspec = dataclasses.replace(s["tspec"], routing_impl=impl)
    tok = s["tokens"] if tokens is None else tokens
    jb = tb = None
    if mode == "train" and impl == "ragged":
        jb = jax_ragged_bucket(jp, tok.shape[1], spec=jspec)
        tb = ragged_bucket(tp, tok.shape[1], spec=tspec)
        assert tb == jb
    want, jaux = jax_forward(s["params"], s["rp"], {"tokens": jnp.asarray(
        tok)}, s["jcfg"], jspec, mode=mode, policy=jp, bucket=jb)
    got, taux = forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(
        tok)}, s["tcfg"], tspec, mode=mode, policy=tp, bucket=tb)
    return (np.asarray(want), jaux), (got.detach().numpy(), taux), tb


def _check_aux(jaux, taux):
    for name in ("load", "topk", "sel_rate"):
        np.testing.assert_allclose(float(getattr(taux, name)),
                                   float(getattr(jaux, name)), **TOL)


# ------------------------------ JAX parity -----------------------------------

@pytest.mark.parametrize("token", [1.0, 0.5])
@pytest.mark.parametrize("depth", [1.0, 0.75, 0.5])
@pytest.mark.parametrize("impl", ["ragged", "dense_mask"])
def test_train_forward_matches_jax(impl, depth, token):
    s = pair()
    jp, tp = _policies(s, [(token, depth)], tensor=False)
    (want, jaux), (got, taux), bucket = _run_both(s, "train", jp, tp, impl)
    np.testing.assert_allclose(got, want, **TOL)
    _check_aux(jaux, taux)
    if impl == "ragged":    # depth x token is the plan capacity
        full = depth * token >= 1.0
        assert (bucket == IDENTITY_BUCKET) == full
    np.testing.assert_allclose(float(taux.sel_rate), depth * token,
                               atol=1.0 / S)


@pytest.mark.parametrize("path", ["ragged", "dense_mask", "infer"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_spec_variants_match_jax(variant, path, monkeypatch):
    s = pair(variant)
    rows = [(0.5, 0.75), (1.0, 0.5)]
    if path == "infer":
        margins = RouterMargins(monkeypatch)
        jp, tp = _policies(s, rows)
        (want, jaux), (got, taux), _ = _run_both(s, "infer", jp, tp)
        margins.check()
    else:
        jp, tp = _policies(s, rows[:1], tensor=False)
        (want, jaux), (got, taux), _ = _run_both(s, "train", jp, tp, path)
    np.testing.assert_allclose(got, want, **TOL)
    _check_aux(jaux, taux)
    assert float(taux.sel_rate) < 1.0


@pytest.mark.parametrize("depth", [1.0, 0.75, 0.5])
def test_infer_forward_matches_jax(depth, monkeypatch):
    s = pair()
    margins = RouterMargins(monkeypatch)
    jp, tp = _policies(s, [(1.0, depth), (0.5, depth)])
    (want, jaux), (got, taux), _ = _run_both(s, "infer", jp, tp)
    margins.check()
    np.testing.assert_allclose(got, want, **TOL)
    _check_aux(jaux, taux)


def test_prefill_caches_and_decode_logits_match_jax(monkeypatch):
    """Mixed per-row (token, depth) budgets: the ring caches of a prefill
    (``valid`` holes where the depth router skipped a token at a layer)
    and three decode steps, logits and caches."""
    s = pair()
    margins = RouterMargins(monkeypatch)
    jp, tp = _policies(s, [(0.75, 0.5), (1.0, 0.75)])
    tok = s["tokens"][:, :12]
    L = 32
    jl, jc = jax_prefill(s["params"], s["rp"], {"tokens": jnp.asarray(tok)},
                         s["jcfg"], s["jspec"], mode="infer",
                         max_cache_len=L, policy=jp)
    tl, tc = prefill(s["tparams"], s["trp"], {"tokens": torch.from_numpy(
        tok)}, s["tcfg"], s["tspec"], mode="infer", max_cache_len=L,
        policy=tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def check_caches():
        holes = []
        for i, layer in enumerate(tc["layers"]):
            ja = jax.tree.map(lambda a: np.asarray(a[i]), jc["scan"][0])
            for name in ("k", "v"):
                np.testing.assert_allclose(layer["attn"][name].numpy(),
                                           ja["attn"][name], **TOL)
            for name in ("valid", "pos"):
                np.testing.assert_array_equal(layer["attn"][name].numpy(),
                                              ja["attn"][name])
            a = layer["attn"]
            holes.append(int(((a["pos"] >= 0) & ~a["valid"]).sum()))
        return holes
    holes = check_caches()
    assert min(holes) > 0       # every layer skipped some (token, row)

    rng = np.random.default_rng(1)
    t = np.asarray([12, 12], np.int32)
    for _ in range(3):
        nxt = rng.integers(0, s["tcfg"].vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jax_decode_step(s["params"], s["rp"], jnp.asarray(nxt), jc,
                                 jnp.asarray(t), s["jcfg"], s["jspec"],
                                 mode="infer", policy=jp)
        tl, tc = decode_step(s["tparams"], s["trp"], torch.from_numpy(nxt),
                             tc, torch.from_numpy(t), s["tcfg"], s["tspec"],
                             mode="infer", policy=tp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        t = t + 1
    check_caches()
    margins.check()


# --------------------------------- engine ------------------------------------

BATCH, MAX_SEQ, PS, NEW = 4, 24, 8, 6
BUDGETS = (0.4, 0.7, 1.0, None)


def _engine(s, layout, mode="infer", batch=BATCH):
    kw = dict(kv_layout="paged", page_size=PS) if layout == "paged" else {}
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=batch, max_seq=MAX_SEQ,
                         device="cpu", **kw)


def _prompts(s, layout):
    rng = np.random.default_rng(3)
    plen = 12 if layout == "paged" else 8
    return [rng.integers(0, s["tcfg"].vocab_size, plen).astype(np.int32)
            for _ in BUDGETS]


def _staggered(eng, make_req, prompts):
    """tests/test_depth.py's workload: r0 two tokens in when r1 lands, then
    r2 and r3 together; slots at different t and skip histories."""
    reqs = [make_req(p, NEW, budget=b) for p, b in zip(prompts, BUDGETS)]
    h0 = eng.submit(reqs[0])
    eng.step()
    eng.step()
    h1 = eng.submit(reqs[1])
    eng.step()
    handles = [h0, h1, eng.submit(reqs[2]), eng.submit(reqs[3])]
    while not all(h.done for h in handles):
        assert eng.step() > 0
    return [[int(x) for x in h.output] for h in handles]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_greedy_tokens_match_jax_engine(layout, monkeypatch):
    s = pair()
    prompts = _prompts(s, layout)
    jkw = dict(kv_layout="paged", page_size=PS) if layout == "paged" else {}
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ, **jkw)
    want = _staggered(jeng, JaxRequest, prompts)
    margins = RouterMargins(monkeypatch)
    eng = _engine(s, layout)
    got = _staggered(eng, GenRequest, prompts)
    margins.check()
    assert got == want
    if layout == "paged":
        assert eng.paged_stats()["allocated"] == 0


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_staggered_equals_solo_with_fixed_decode_shapes(layout, monkeypatch):
    """Each request alone gives its staggered tokens (slots at different t
    and per-layer skip histories: the validity masks keep the neighbours'
    attention exact); every decode step sees the same tensor shapes and
    dtypes whatever the budget mix."""
    s = pair()
    prompts = _prompts(s, layout)
    sigs = set()
    real = serve_mod.decode_step

    def recording(params, rp, tok, caches, t, cfg, spec, mode, policy,
                  **paged):
        leaves = [tok, t] + list(paged.values()) + [
            getattr(policy, f.name) for f in dataclasses.fields(policy)]
        leaves += [c for layer in caches["layers"]
                   for c in layer["attn"].values()]
        sigs.add(tuple((tuple(x.shape), x.dtype) for x in leaves))
        return real(params, rp, tok, caches, t, cfg, spec, mode=mode,
                    policy=policy, **paged)

    monkeypatch.setattr(serve_mod, "decode_step", recording)
    stag = _staggered(_engine(s, layout), GenRequest, prompts)
    assert len(sigs) == 1
    monkeypatch.undo()
    for p, b, want in zip(prompts, BUDGETS, stag):
        solo = _engine(s, layout, batch=2).generate(
            [GenRequest(p, NEW, budget=b)])[0]
        assert list(solo) == want


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_budget_one_is_the_teacher_in_decode(layout):
    s = pair()
    rng = np.random.default_rng(2)
    reqs = [GenRequest(rng.integers(0, s["tcfg"].vocab_size, 8).astype(
        np.int32), NEW, budget=1.0) for _ in range(2)]
    base = _engine(s, layout, mode="base").generate(reqs)
    got = _engine(s, layout).generate(reqs)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)


# ------------------------- the port's own properties -------------------------

def _forward(s, pol, tokens=None, bucket=None, spec=None, mode="train"):
    tok = s["tokens"] if tokens is None else tokens
    return forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(tok)},
                   s["tcfg"], spec or s["tspec"], mode=mode, policy=pol,
                   bucket=bucket)[0]


def test_budget_one_is_the_teacher_in_train_mode():
    s = pair()
    teacher = forward(s["tparams"], None, {"tokens": torch.from_numpy(
        s["tokens"])}, s["tcfg"], None, mode="base")[0]
    for pol in (ElasticPolicy.uniform(1.0, static=True),
                ElasticPolicy.teacher(static=True)):
        assert torch.equal(_forward(s, pol), teacher)
    pol = ElasticPolicy.uniform(1.0)
    assert ragged_bucket(pol, S, spec=s["tspec"]) == IDENTITY_BUCKET
    assert torch.equal(_forward(s, pol, bucket=IDENTITY_BUCKET), teacher)


def test_partial_depth_plans_a_bucket_at_full_token_budget():
    s = pair()
    part = ElasticPolicy.uniform(1.0).replace(depth_capacity=0.5)
    b = ragged_bucket(part, S, spec=s["tspec"])
    assert b not in (IDENTITY_BUCKET, None) and b < S
    teacher = _forward(s, ElasticPolicy.uniform(1.0), bucket=IDENTITY_BUCKET)
    assert not torch.allclose(_forward(s, part, bucket=b), teacher)


@pytest.mark.parametrize("depth", [0.4, 0.6, 0.75])
def test_ragged_matches_dense(depth):
    s = pair()
    dense = dataclasses.replace(s["tspec"], routing_impl="dense_mask")
    pol = ElasticPolicy.uniform(0.8).replace(depth_capacity=depth)
    bucket = ragged_bucket(pol, S, spec=s["tspec"])
    assert bucket not in (IDENTITY_BUCKET, None)
    np.testing.assert_allclose(_forward(s, pol, bucket=bucket).numpy(),
                               _forward(s, pol, spec=dense).numpy(),
                               atol=1e-4)


def test_mixed_per_row_depth_budgets_match_solo_rows():
    s = pair()
    pols = [ElasticPolicy.uniform(0.75).replace(depth_capacity=d)
            for d in (0.5, 1.0)]
    mixed = ElasticPolicy.stack(pols)
    out = _forward(s, mixed, bucket=ragged_bucket(mixed, S, spec=s["tspec"]))
    for i, pol in enumerate(pols):
        row = pol.to("cpu")
        solo = _forward(s, row, tokens=s["tokens"][i:i + 1],
                        bucket=ragged_bucket(row, S, spec=s["tspec"]))
        np.testing.assert_allclose(out[i:i + 1].numpy(), solo.numpy(),
                                   atol=1e-4)


def test_flops_monotone_in_depth_and_composed():
    """Counted forward FLOPs track the depth budget, compose with the token
    budget and stay flat on the dense reference path (256 tokens, vocab
    256, static policies: the ragged plan buckets)."""
    from torch.utils.flop_counter import FlopCounterMode
    s = pair()
    cfg = dataclasses.replace(s["tcfg"], vocab_size=256)
    params = dict(s["tparams"], embed=s["tparams"]["embed"][:256])
    if "lm_head" in params:
        params["lm_head"] = params["lm_head"][:, :256]
    tok = {"tokens": torch.zeros((2, 256), dtype=torch.int64)}

    def flops_at(spec, depth, token):
        pol = ElasticPolicy.uniform(token, static=True).replace(
            depth_capacity=depth)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            forward(params, s["trp"], tok, cfg, spec, mode="train",
                    policy=pol)
        return fc.get_total_flops()

    assert cfg.padded_vocab == 256
    spec = dataclasses.replace(s["tspec"], mha_head_routed=False,
                               lora_rank=0)
    fl = {d: flops_at(spec, d, 1.0) for d in (1.0, 0.75, 0.5, 0.25)}
    assert fl[1.0] > fl[0.75] > fl[0.5] > fl[0.25], fl
    assert fl[0.5] <= 0.6 * fl[1.0], fl
    both = flops_at(spec, 0.5, 0.5)
    assert both < fl[0.5] and both < flops_at(spec, 1.0, 0.5)
    dense = dataclasses.replace(spec, routing_impl="dense_mask")
    fd = {d: flops_at(dense, d, 1.0) for d in (1.0, 0.5)}
    assert fd[0.5] > 0.95 * fd[1.0], fd


def test_router_init_draws_depth_last():
    """The depth router is each layer's last draw: the first layer's other
    routers are those of the same spec without depth (so a spec without
    depth draws what it drew before depth existed)."""
    from repro_torch.models import router_init
    from repro_torch.optim.optimizer import tree_leaves
    s = pair()
    no_depth = dataclasses.replace(s["tspec"], depth_routed=False)
    a, b = (router_init(torch.Generator().manual_seed(5), s["tcfg"], sp,
                        device="cpu")["layers"]
            for sp in (no_depth, s["tspec"]))
    assert all(set(lb) - set(la) == {"depth"} for la, lb in zip(a, b))
    first = {k: v for k, v in b[0].items() if k != "depth"}
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]),
                                                 tree_leaves(first)))
