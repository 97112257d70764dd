"""The recurrent families (Mamba2's SSD mixer, RecurrentGemma's RG-LRU hybrid
with its windowed MQA at one kv-head) against the JAX package, on the CPU
in f32 at the smoke variants: the mixers (``ssd_chunked`` with a prime
length's chunk of 1, ``ssm_apply`` / ``ssm_decode`` and ``rglru_apply`` /
``rglru_decode`` with a keep mask, an initial state and a conv state),
forward in base / infer / train, prefill caches and decode steps, decode
40 steps past the window, ``solve_budget``, a distillation step's loss and
router gradients, the ring engine's tokens and final caches; and within
the port: budget 1.0 == the teacher bit for bit, staggered == solo, the
paged refusal, the interop and checkpoint round trips of the ``mixer``
trees and the recurrent caches, and a decode step that writes the state
and conv rows in place.

JAX runs its jnp oracles (``kernel_backend="ref"``), the port its plain
versions (CPU tensors). Tolerances: f32 rtol=atol=1e-5 for outputs,
logits, states and caches (the RG-LRU scan's tree differs from
``associative_scan``'s; the measured error stays far inside), 1e-4 for
losses and router gradients as in tests/test_torch_train.py. Routing
decisions are held equal by seeds whose token-router logits clear their
thresholds (``RouterMargins``). Each JAX engine run is shared through a
module fixture.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policy import ElasticSpec as JaxSpec  # noqa: E402
from repro.core.policy import ragged_bucket as jax_ragged_bucket  # noqa: E402
from repro.core.policy import solve_budget as jax_solve_budget  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import ElasticSpec, ragged_bucket, solve_budget  # noqa: E402
from repro_torch.core.routing import IDENTITY_BUCKET  # noqa: E402
from repro_torch.interop import (caches_from_numpy, layered_to_numpy,  # noqa: E402
                                 params_to_numpy, train_state_from_tree,
                                 train_state_tree)
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.models import rglru as G  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.optim.optimizer import tree_map  # noqa: E402
from repro_torch.training import (GenRequest, ServingEngine,  # noqa: E402
                                  init_train_state, make_loss_fn)
from tests.test_torch_interop import SPEC_KW, RouterMargins  # noqa: E402
from tests.test_torch_vlm import (as_jax, as_torch, context_pair,  # noqa: E402
                                  policies)

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("mamba2-780m", "recurrentgemma-2b")
# a spec without moefied experts (budget 1.0 is the teacher bit for bit);
# Mamba2's registered one is that already (and it has no heads to route)
NO_EXPERTS = {"mamba2-780m": "registered", "recurrentgemma-2b": "slice"}


def pair(arch, which="registered", seed=0):
    """``arch``'s smoke variant built by the JAX package (f32, jnp oracles)
    and the same weights and routers in the port (``context_pair``).
    ``registered``: the arch's elastic config as the JAX package defines
    it (Mamba2: the mixer's token router only; RecurrentGemma: token,
    head, LoRA and 16 moefied experts); ``slice``: token routing, head
    top-k and LoRA, no experts (budget 1.0 is then the teacher bit for
    bit)."""
    if which == "registered":
        return context_pair(arch, "registered", seed)
    return context_pair(arch, seed=seed, spec_pair=(
        JaxSpec(**SPEC_KW, kernel_backend="ref"), ElasticSpec(**SPEC_KW)))


@functools.lru_cache(maxsize=None)
def _pair(arch, which="registered", seed=0):
    return pair(arch, which, seed)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mixer(s, i):
    """Layer i's mixer params: (JAX tree, port tree)."""
    P = len(s["params"]["scan"])
    jp = jax.tree.map(lambda a: a[i // P], s["params"]["scan"][i % P]["mixer"])
    return jp, s["tparams"]["layers"][i]["mixer"]


# ------------------------------- the mixers ----------------------------------

@pytest.mark.parametrize("S,chunk,init", [(16, 8, False), (17, 1, True),
                                          (12, 4, True)],
                         ids=["S16-c8", "prime-S17-c1-init", "S12-c4-init"])
def test_ssd_chunked_matches_jax(S, chunk, init):
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 5
    x, bm, cm = _rand(rng, B, S, H, P), _rand(rng, B, S, N), _rand(rng, B, S, N)
    dt = np.abs(_rand(rng, B, S, H, scale=0.5))
    a = -np.exp(_rand(rng, H, scale=0.3))
    h0 = _rand(rng, B, H, P, N) if init else None
    want_y, want_h = jax_ssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
        jnp.asarray(cm), chunk, None if h0 is None else jnp.asarray(h0))
    t = torch.from_numpy
    got_y, got_h = SSM.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), chunk,
                                   None if h0 is None else t(h0))
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), **TOL)
    assert SSM.chunk_for(17, 16) == 1 and SSM.chunk_for(300, 256) == 150
    assert SSM.chunk_for(13, 16) == 13


def _mixer_case(kind, S, with_state, seed):
    """(JAX outputs, port outputs) of a full-sequence pass then three
    decode steps of layer 0's mixer, with a keep mask and a write gate."""
    arch = "mamba2-780m" if kind == "ssm" else "recurrentgemma-2b"
    s = _pair(arch)
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jp, tp = _mixer(s, 0)
    rng = np.random.default_rng(seed)
    B, D = 2, tcfg.d_model
    x = _rand(rng, B, S, D)
    keep = rng.random((B, S)) > 0.3
    if kind == "ssm":
        shape = (B, tcfg.n_ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
        conv_w = tcfg.d_inner + 2 * tcfg.ssm_state
        japply, jdec = jax_ssm.ssm_apply, jax_ssm.ssm_decode
        tapply, tdec = SSM.ssm_apply, SSM.ssm_decode
    else:
        shape, conv_w = (B, tcfg.lru_width), tcfg.lru_width
        japply, jdec = jax_rglru.rglru_apply, jax_rglru.rglru_decode
        tapply, tdec = G.rglru_apply, G.rglru_decode
    st = _rand(rng, *shape, scale=0.5) if with_state else None
    cv = _rand(rng, B, tcfg.conv_kernel - 1, conv_w) if with_state else None
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    jy, (jst, jcv) = japply(jp, jnp.asarray(x), jcfg, init_state=j(st),
                            conv_state=j(cv), keep_mask=jnp.asarray(keep))
    ty, (tst, tcv) = tapply(tp, t(x), tcfg, init_state=t(st),
                            conv_state=t(cv), keep_mask=t(keep))
    want, got = [jy, jst, jcv], [ty, tst, tcv]
    jc, tc = {"state": jst, "conv": jcv}, {"state": tst, "conv": tcv}
    for i in range(3):
        xs = _rand(rng, B, 1, D)
        wr = np.array([True, i != 1])
        jy, jc = jdec(jp, jnp.asarray(xs), jc, jcfg, write=jnp.asarray(wr))
        ty, tc = tdec(tp, t(xs), tc, tcfg, write=t(wr))
        want += [jy, jc["state"], jc["conv"]]
        got += [ty, tc["state"], tc["conv"]]
    return want, got


@pytest.mark.parametrize("kind,S,with_state", [
    ("ssm", 16, False), ("ssm", 17, True), ("rglru", 16, True),
    ("rglru", 13, False)],
    ids=["ssm-S16", "ssm-prime-S17-states", "rglru-S16-states",
         "rglru-S13"])
def test_mixer_apply_and_decode_match_jax(kind, S, with_state):
    """The full-sequence mixer (keep mask; an initial state and conv state
    carried in) and three decode steps (one row's write gate off on the
    second), outputs and every state against JAX; a skipped decode token
    leaves its row's state and conv exactly as they were."""
    want, got = _mixer_case(kind, S, with_state, seed=S)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    st2, cv2, st3, cv3 = got[7], got[8], got[4], got[5]
    assert torch.equal(st2[1], st3[1]) and torch.equal(cv2[1], cv3[1])


def test_linear_scan_is_the_recurrence():
    """The Hillis-Steele scan against the step-by-step recurrence."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((2, 37, 6)).astype(np.float64))
    b = torch.from_numpy(rng.standard_normal((2, 37, 6)))
    h, want = torch.zeros(2, 6, dtype=torch.float64), []
    for i in range(37):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(G.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


# ------------------------------- the model ----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,budget,static", [
    ("infer", 0.5, False), ("train", 0.5, False), ("train", 0.5, True)],
    ids=["infer-0.5", "train-0.5", "train-0.5-static"])
def test_forward_matches_jax(arch, mode, budget, static, monkeypatch):
    """Infer and train (tensor: the dense path; static: the plan) against
    JAX; base mode is held in ``test_decode_matches_forward_base_mode``."""
    s = _pair(arch)
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 16, 1)}
    jp, tp = policies([budget], cfg, static, s["tspec"])
    margins = RouterMargins(monkeypatch)
    got, aux = forward(s["tparams"], s["trp"], as_torch(batch), cfg,
                       s["tspec"], mode=mode, policy=tp)
    want, jaux = jax_forward(s["params"], s["rp"], as_jax(batch), s["jcfg"],
                             s["jspec"], mode=mode, policy=jp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.sel_rate), float(jaux.sel_rate),
                               **LOSS_TOL)
    if mode == "infer":
        margins.check()


def _check_caches(jc, tc, cfg):
    want = _flatten(jc)
    got = layered_to_numpy({}, cfg, None, {"c": tc})
    got = {k[len("['c']"):]: v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype == bool or w.dtype.kind == "i":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_jax(arch, monkeypatch):
    """Mixed per-row budgets over a prime prompt length past ``ssm_chunk``
    (Mamba2's chunk 1): every layer's cache (``state``/``conv`` and the windowed ring)
    and three decode steps; then JAX's caches carried into the port
    (``caches_from_numpy``) continue decoding as JAX's do."""
    s = _pair(arch)
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 17, 5)}
    jp, tp = policies([0.5, 1.0], cfg, spec=s["tspec"])
    margins = RouterMargins(monkeypatch)
    L = 24
    jl, jc = jax.jit(functools.partial(
        jax_prefill, cfg=s["jcfg"], ecfg=s["jspec"], mode="infer",
        max_cache_len=L))(s["params"], s["rp"], as_jax(batch), policy=jp)
    jstep = jax.jit(functools.partial(jax_decode_step, cfg=s["jcfg"],
                                      ecfg=s["jspec"], mode="infer"))
    tl, tc = prefill(s["tparams"], s["trp"], as_torch(batch), cfg,
                     s["tspec"], mode="infer", max_cache_len=L, policy=tp)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _check_caches(jc, tc, cfg)
    carried = caches_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                device="cpu")
    t = np.asarray([17, 17], np.int32)
    for i in range(3):
        nxt = _tokens(cfg, 2, 1, 10 + i)
        jl, jc = jstep(s["params"], s["rp"], jnp.asarray(nxt), jc,
                       jnp.asarray(t), policy=jp)
        for c in (tc, carried):
            tl, _ = decode_step(s["tparams"], s["trp"], torch.from_numpy(nxt),
                                c, torch.from_numpy(t), cfg, s["tspec"],
                                mode="infer", policy=tp)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        t = t + 1
    _check_caches(jc, tc, cfg)
    _check_caches(jc, carried, cfg)
    margins.check()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_base_mode(arch):
    """tests/test_models_smoke.py's check on the port: prefill then N
    decode steps reproduce the full-sequence forward position by position
    in teacher mode (the state hand-off; RecurrentGemma's ring wraps at
    window 16), and the forward is JAX's."""
    s = _pair(arch)
    cfg = s["tcfg"]
    B, S, n_dec = 2, 24, 6
    toks = _tokens(cfg, B, S, 3)
    full, _ = forward(s["tparams"], None, as_torch({"tokens": toks}), cfg,
                      None, mode="base")
    jfull, _ = jax_forward(s["params"], None, as_jax({"tokens": toks}),
                           s["jcfg"], None, mode="base")
    np.testing.assert_allclose(_np(full), np.asarray(jfull), **TOL)
    logits, caches = prefill(s["tparams"], None,
                             as_torch({"tokens": toks[:, :S - n_dec]}), cfg,
                             None, mode="base", max_cache_len=S)
    tol = dict(atol=2e-3, rtol=1e-3)      # tests/test_models_smoke.py:84
    np.testing.assert_allclose(_np(logits), _np(full[:, S - n_dec - 1]), **tol)
    for i in range(n_dec):
        t = S - n_dec + i
        logits, caches = decode_step(
            s["tparams"], None, torch.from_numpy(toks[:, t:t + 1]), caches,
            torch.tensor(t, dtype=torch.int32), cfg, None, mode="base")
        np.testing.assert_allclose(_np(logits), _np(full[:, t]), **tol)


def test_decode_past_the_window_matches_jax():
    """tests/test_models_smoke.py's window check, held to JAX: 40 greedy
    steps past RecurrentGemma's window of 16 on a 64-slot max_seq (its
    local ring holds 16), logits every step and the final caches."""
    s = _pair("recurrentgemma-2b")
    cfg = s["tcfg"]
    toks = _tokens(cfg, 1, 8, 4)
    jl, jc = jax_prefill(s["params"], None, as_jax({"tokens": toks}),
                         s["jcfg"], None, mode="base", max_cache_len=64)
    tl, tc = prefill(s["tparams"], None, as_torch({"tokens": toks}), cfg,
                     None, mode="base", max_cache_len=64)
    assert tc["layers"][2]["attn"]["k"].shape[1] == 16
    jstep = jax.jit(functools.partial(jax_decode_step, cfg=s["jcfg"],
                                      ecfg=None, mode="base"))
    for t in range(8, 48):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert int(_np(tl).argmax(-1)[0]) == int(tok[0, 0])
        jl, jc = jstep(s["params"], None, jnp.asarray(tok), jc, jnp.int32(t))
        tl, tc = decode_step(s["tparams"], None, torch.from_numpy(tok), tc,
                             torch.tensor(t, dtype=torch.int32), cfg, None,
                             mode="base")
        assert bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _check_caches(jc, tc, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_solve_budget_matches_jax(arch):
    """The budget solver's cost model counts the SSD and RG-LRU mixers as
    JAX's does (full and smoke configs): the same capacities."""
    s = _pair(arch)
    for variant in ("smoke", "full"):
        jcfg, tcfg = jax_get_config(arch, variant), get_config(arch, variant)
        for b in (0.3, 0.5, 0.8):
            want = jax_solve_budget(jcfg, s["jspec"], b)
            got = solve_budget(tcfg, s["tspec"], b)
            for f in ("mha_token_capacity", "mlp_token_capacity",
                      "mha_head_topk", "mlp_expert_topk"):
                np.testing.assert_allclose(float(getattr(got, f)),
                                           float(getattr(want, f)),
                                           rtol=1e-12, err_msg=f)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_router_grads_match_jax(arch):
    """A distillation step at budget 0.6 as the trainer takes it: a tensor
    policy with its ragged bucket (the recurrent mixer takes the plan's
    membership as its mask); the loss, metrics and every router gradient
    (the ``tok_mixer`` routers of the recurrent layers are non-zero)."""
    s = _pair(arch)
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 16, 7)}
    jp, tp = policies([0.6], cfg, False, s["tspec"])
    # the spec-free bucket: with the spec, Mamba2's one routed token knob
    # gets the identity bucket at any budget, in both packages
    kw = dict(bucket=ragged_bucket(tp, 16))
    assert kw["bucket"] == jax_ragged_bucket(jp, 16)
    assert ragged_bucket(tp, 16, spec=s["tspec"]) == jax_ragged_bucket(
        jp, 16, spec=s["jspec"])
    assert kw["bucket"] not in (None, IDENTITY_BUCKET)
    lf = jax.jit(jax.value_and_grad(jax_make_loss_fn(s["jcfg"], s["jspec"]),
                                    has_aux=True), static_argnames=("bucket",))
    (jloss, jm), jg = lf(s["rp"], s["params"], as_jax(batch), jp, **kw)
    jg = _flatten({"routers": jg})
    rp = tree_map(lambda t: t.clone().requires_grad_(True), s["trp"])
    loss, m = make_loss_fn(cfg, s["tspec"])(rp, s["tparams"],
                                            as_torch(batch), tp, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    for k in ("distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   **LOSS_TOL, err_msg=k)
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, rp)
    got = layered_to_numpy({}, cfg, s["tspec"], {"routers": grads})
    assert sorted(got) == sorted(jg)
    kinds = cfg.layer_kinds
    rec = [i for i, k in enumerate(kinds) if k in ("ssm", "rglru")]
    assert all(float(grads["layers"][i]["tok_mixer"]["w"].abs().max()) > 0
               for i in rec)
    for key, want in jg.items():
        scale = max(1e-3, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)


# ------------------------------- serving -------------------------------------

BATCH, MAX_SEQ, NEW = 3, 32, 6
# three prompt lengths (each a compile of JAX's engine): 17 is a prime
# past the smoke's ssm_chunk of 16 (chunk 1)
LENS = (8, 17, 12, 17, 8)
BUDGETS = [1.0, 0.5, None, 0.75, 0.5]


def _workload(cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in LENS]


def _staggered(engine, make_req, prompts, budgets, first=2):
    """Two requests, two steps, the rest: admissions land mid-decode."""
    handles = [engine.submit(make_req(p, NEW, budget=b))
               for p, b in zip(prompts[:first], budgets[:first])]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(make_req(p, NEW, budget=b))
                for p, b in zip(prompts[first:], budgets[first:])]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return [list(h.output) for h in handles]


def _port_engine(s, mode="infer", **kw):
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu", **kw)


def engine_runs_for(archs, pair_fn, workload=_workload):
    """Each arch's staggered mixed-budget workload through JAX's ring
    engine and the port's: tokens, final caches and router margins."""
    out = {}
    for arch in archs:
        s = pair_fn(arch)
        prompts = workload(s["tcfg"])
        jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                         mode="infer", batch_size=BATCH, max_seq=MAX_SEQ)
        want = _staggered(jeng, JaxRequest, prompts, BUDGETS)
        with pytest.MonkeyPatch.context() as mp:
            margins = RouterMargins(mp)
            teng = _port_engine(s)
            got = _staggered(teng, GenRequest, prompts, BUDGETS)
        out[arch] = dict(want=want, got=got, margins=margins,
                         jax_caches=jax.tree.map(np.asarray, jeng._caches),
                         port_caches=teng._caches, cfg=s["tcfg"])
    return out


@pytest.fixture(scope="module")
def engine_runs():
    return engine_runs_for(ARCHS, _pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_caches_match_jax(engine_runs, arch):
    run = engine_runs[arch]
    run["margins"].check()
    assert run["got"] == run["want"]
    _check_caches(run["jax_caches"], run["port_caches"], run["cfg"])


@pytest.mark.parametrize("arch", ARCHS)
def test_budget_one_is_the_teacher_bit_for_bit(arch):
    """Budget 1.0 (one row of a mixed batch) reproduces mode="base"
    exactly, and the engine's budget-1.0 requests give a base engine's
    tokens (a spec without moefied experts)."""
    s = _pair(arch, NO_EXPERTS[arch])
    cfg = s["tcfg"]
    batch = as_torch({"tokens": _tokens(cfg, 2, 12, 11)})
    base, _ = forward(s["tparams"], s["trp"], batch, cfg, s["tspec"],
                      mode="base")
    _, tp = policies([1.0, 0.5], cfg)
    mixed, _ = forward(s["tparams"], s["trp"], batch, cfg, s["tspec"],
                       mode="infer", policy=tp)
    assert torch.equal(mixed[0], base[0])
    assert not torch.equal(mixed[1], base[1])
    prompts = _workload(cfg)
    got = _staggered(_port_engine(s), GenRequest, prompts, BUDGETS)
    want = _staggered(_port_engine(s, mode="base"), GenRequest, prompts,
                      BUDGETS)
    full = [i for i, b in enumerate(BUDGETS) if b == 1.0 or b is None]
    assert [got[i] for i in full] == [want[i] for i in full]


@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_equals_solo(engine_runs, arch):
    s = _pair(arch)
    prompts = _workload(s["tcfg"])
    got = engine_runs[arch]["got"]
    for i in (1, 3):
        solo = _port_engine(s).generate(
            [GenRequest(prompts[i], NEW, budget=BUDGETS[i])])
        assert list(solo[0]) == got[i]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_layout_refuses_recurrent_mixers(arch):
    s = _pair(arch, NO_EXPERTS[arch])
    with pytest.raises(ValueError, match="all-'attn'"):
        _port_engine(s, kv_layout="paged", page_size=8)


def test_decode_writes_the_recurrent_state_in_place():
    """A decode step writes each recurrent layer's ``state`` and ``conv``
    into the engine's cache tensors (a captured decode graph reads them):
    every leaf keeps its storage while its values move."""
    s = _pair("recurrentgemma-2b", "slice")
    eng = _port_engine(s)
    leaves = [(i, name, leaf) for i, layer in enumerate(eng._caches["layers"])
              for kind, c in layer.items() for name, leaf in c.items()]
    ptrs = [leaf.data_ptr() for _, _, leaf in leaves]
    h = eng.submit(GenRequest(_workload(s["tcfg"])[0], NEW))
    eng.step()
    before = {(i, n): leaf.clone() for i, n, leaf in leaves}
    eng.step()
    assert [leaf.data_ptr() for _, _, leaf in leaves] == ptrs
    rec = eng._caches["layers"][0]["rglru"]
    assert not torch.equal(rec["state"][0], before[(0, "state")][0])
    assert not torch.equal(rec["conv"][0], before[(0, "conv")][0])
    while not h.done:
        eng.step()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_routers_caches_and_train_state_round_trip(arch, tmp_path):
    """The ``mixer`` trees carried from JAX and back bit for bit through the scan/tail split of
    the heterogeneous period, the recurrent caches of a prefill, and a
    train state of the routers through the port's Checkpointer."""
    s = _pair(arch)
    cfg, spec = s["tcfg"], s["tspec"]
    back = params_to_numpy(s["tparams"], s["trp"], cfg, spec)
    assert sorted(back) == sorted(s["flat"])
    for k, v in s["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    kind = "ssm" if arch.startswith("mamba") else "rglru"
    leaves = {"ssm": ("in_z", "in_x", "in_b", "in_c", "in_dt", "conv_x",
                      "a_log", "d_skip", "dt_bias", "norm_scale", "out_proj"),
              "rglru": ("w_y", "w_x", "conv_w", "conv_b", "w_a", "b_a",
                        "w_i", "b_i", "lam", "w_out")}[kind]
    for name in leaves:
        assert any(k.endswith(f"['mixer']['{name}']") for k in back), name
    _, jc = jax_prefill(s["params"], None, as_jax({"tokens": _tokens(
        cfg, 1, 9, 2)}), s["jcfg"], None, mode="base", max_cache_len=16)
    tc = caches_from_numpy(jax.tree.map(np.asarray, jc), cfg, device="cpu")
    assert tc["layers"][0][kind]["state"].dtype == torch.float32
    _check_caches(jc, tc, cfg)
    state = init_train_state(s["trp"])
    ck = Checkpointer(str(tmp_path))
    ck.save(3, train_state_tree(state, cfg, spec), extra={"opt_step": 0},
            blocking=True)
    like = tree_map(torch.zeros_like, train_state_tree(state, cfg, spec))
    loaded, extra = ck.restore(3, like)
    got = train_state_from_tree(loaded, extra["opt_step"], cfg, spec)
    want = layered_to_numpy({}, cfg, spec, {"r": s["trp"]})
    have = layered_to_numpy({}, cfg, spec, {"r": got.router_params})
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_rglru_gate_weights_stay_f32_in_a_bf16_model():
    """JAX keeps ``w_a``/``w_i`` in f32 in a bf16 model: the port's init
    does, and the interop carries those leaves' dtypes as they are."""
    from repro_torch.models import model as M
    cfg = get_config("recurrentgemma-2b", "smoke")
    p = M.model_init(torch.Generator().manual_seed(0), cfg, None,
                     device="cpu")["layers"][0]["mixer"]
    assert p["w_a"].dtype == p["w_i"].dtype == torch.float32
    assert p["w_x"].dtype == p["w_out"].dtype == torch.bfloat16
