"""The windowed and remaining attention-only families against the JAX
package, on the CPU in f32 at the smoke variants: Gemma-3 (5:1 local
sliding windows; the smoke's window 16 evicts), Granite (48:1 MQA at full
size, ungated GELU, layernorm, qkv bias), Phi-3-medium and Grok-1 (native
experts, geglu). Windowed gathered attention against JAX's ``_mask`` +
``sdpa``; forward in base / infer / train (Gemma-3's plan path reaches the
windowed gathered attention); prefill caches and decode steps with the
local rings wrapping; decode 40 steps past the window; ``solve_budget``; a
distillation step's loss and router gradients; the ring engine's tokens
and final caches; and within the port: budget 1.0 == the teacher bit for
bit, staggered == solo, the paged refusals, the interop round trips of
the expert trees and of wrapped ring caches.

JAX runs its jnp oracles (``kernel_backend="ref"``), the port its plain
versions (CPU tensors), at the tolerances of tests/test_torch_recurrent.py.
Specs: Gemma-3, Granite and Phi-3 register no elastic config, so both
sides take the port's default (token routing, head top-k, LoRA: JAX's
default would moefy the MLPs); Grok-1 its registered one (expert routing
over its native experts).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policy import ragged_bucket as jax_ragged_bucket  # noqa: E402
from repro.core.policy import solve_budget as jax_solve_budget  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.training import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.configs import get_config, get_elastic  # noqa: E402
from repro_torch.core.policy import (ragged_bucket, solve_budget,  # noqa: E402
                                     spec_from_config)
from repro_torch.core.routing import IDENTITY_BUCKET  # noqa: E402
from repro_torch.interop import (caches_from_numpy, layered_to_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.optim.optimizer import tree_map  # noqa: E402
from repro_torch.training import GenRequest, make_loss_fn  # noqa: E402
from tests.test_torch_interop import RouterMargins  # noqa: E402
from tests.test_torch_recurrent import (BUDGETS, LOSS_TOL, NEW, TOL,  # noqa: E402
                                        _check_caches, _np, _port_engine,
                                        _staggered, _tokens,
                                        engine_runs_for, pair)
from tests.test_torch_vlm import as_jax, as_torch, policies  # noqa: E402

ARCHS = ("gemma3-27b", "granite-34b", "phi3-medium-14b", "grok-1-314b")
# Grok-1: its registered spec; the others: the port's default (which is
# the serving slice's spec, no experts)
WHICH = {"gemma3-27b": "slice", "granite-34b": "slice",
         "phi3-medium-14b": "slice", "grok-1-314b": "registered"}


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    return pair(arch, WHICH[arch], seed)


def test_unregistered_archs_take_the_port_default_spec():
    for arch in ARCHS[:3]:
        spec = spec_from_config(get_elastic(arch))
        assert spec == _pair(arch)["tspec"], arch


# ----------------------- windowed gathered attention -------------------------

def _gathered(rng, B, S, full):
    """(B, S) ascending positions: a random subset of [0, full) per row."""
    return np.stack([np.sort(rng.choice(full, S, replace=False))
                     for _ in range(B)]).astype(np.int32)


@pytest.mark.parametrize("H,K,window", [(4, 2, 5), (6, 1, 9)],
                         ids=["gqa-w5", "mqa-w9"])
def test_windowed_gathered_attention_matches_jax(H, K, window):
    """The plain path against JAX's ``_mask`` + ``sdpa`` over a gathered
    (position-ascending, gapped) buffer with a masked tail: the window is
    measured by position, not by index."""
    rng = np.random.default_rng(window)
    B, S, Dh = 2, 12, 16
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, K, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, K, Dh)).astype(np.float32)
    pos = _gathered(rng, B, S, 40)
    valid = np.ones((B, S), bool)
    valid[1, 9:] = False
    mask = jax_attention._mask(jnp.asarray(pos), jnp.asarray(pos), True,
                               window, jnp.asarray(valid))
    want = jax_attention.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask)
    t = torch.from_numpy
    got = A.windowed_gathered_attention(t(q), t(k), t(v), t(pos), window,
                                        True, t(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # by index the window would keep other keys: the two masks differ here
    idx = np.arange(S)
    by_index = (idx[:, None] - idx[None, :] < window)
    by_pos = (pos[0][:, None] - pos[0][None, :] < window)
    assert (np.tril(by_index) != np.tril(by_pos)).any()


def test_attn_apply_routes_windowed_calls(monkeypatch):
    """A windowed non-gathered call goes to ``ops.flash_attention`` with its
    window; a windowed gathered one (and only that) to the plain path, with
    the JAX package's result; a global gathered one to the flash op."""
    s = _pair("gemma3-27b")
    cfg = s["tcfg"]
    p = s["tparams"]["layers"][0]["attn"]
    jpar = jax.tree.map(lambda a: a[0], s["params"]["scan"][0]["attn"])
    calls = []
    real = ops.flash_attention

    def rec(*a, **kw):
        calls.append((kw.get("window"), kw.get("kv_count") is not None))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", rec)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = _gathered(rng, 2, 12, 30)
    valid = np.ones((2, 12), bool)
    valid[0, 10:] = False
    cnt = valid.sum(1).astype(np.int32)
    t = torch.from_numpy
    A.attn_apply(p, t(x), cfg=cfg, positions=torch.arange(12), window=16)
    assert calls == [(16, False)]
    got, _, _ = A.attn_apply(p, t(x), cfg=cfg, positions=t(pos), window=5,
                             kv_valid=t(valid), kv_count=t(cnt),
                             gathered=True)
    assert calls == [(16, False)]
    want, _, _ = jax_attention.attn_apply(
        jpar, jnp.asarray(x), cfg=s["jcfg"], positions=jnp.asarray(pos),
        window=5, kv_valid=jnp.asarray(valid), kv_count=jnp.asarray(cnt),
        backend="ref", gathered=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    A.attn_apply(p, t(x), cfg=cfg, positions=t(pos), window=0,
                 kv_valid=t(valid), kv_count=t(cnt), gathered=True)
    assert calls == [(16, False), (0, True)]


# ------------------------------- the model ----------------------------------

FORWARD = [(a, m) for a in ARCHS for m in ("infer-0.5", "train-0.5-static")]
FORWARD.append(("gemma3-27b", "train-0.5"))


@pytest.mark.parametrize("arch,mode", FORWARD,
                         ids=[f"{a}-{m}" for a, m in FORWARD])
def test_forward_matches_jax(arch, mode, monkeypatch):
    """Infer and train (static: the plan path, whose Gemma-3 local layers
    take the windowed gathered attention; tensor: the dense path) over 24
    tokens, past Gemma-3's window of 16; base mode is held in
    ``test_decode_matches_forward_base_mode``."""
    s = _pair(arch)
    cfg = s["tcfg"]
    name, _, rest = mode.partition("-")
    budget = float(rest.split("-")[0]) if rest else 1.0
    static = mode.endswith("static")
    batch = {"tokens": _tokens(cfg, 2, 24, 1)}
    jp, tp = policies([budget], cfg, static, s["tspec"])
    margins = RouterMargins(monkeypatch)
    got, aux = forward(s["tparams"], s["trp"], as_torch(batch), cfg,
                       s["tspec"], mode=name, policy=tp)
    want, jaux = jax_forward(s["params"], s["rp"], as_jax(batch), s["jcfg"],
                             s["jspec"], mode=name, policy=jp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.sel_rate), float(jaux.sel_rate),
                               **LOSS_TOL)
    if name == "infer":
        margins.check()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_jax(arch, monkeypatch):
    """Mixed per-row budgets over a 20-token prompt (Gemma-3's local rings
    of 16 wrap in prefill): every layer's cache and three decode steps;
    JAX's caches carried into the port continue as JAX's do."""
    s = _pair(arch)
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 20, 5)}
    jp, tp = policies([0.5, 1.0], cfg, spec=s["tspec"])
    margins = RouterMargins(monkeypatch)
    L = 32
    jl, jc = jax.jit(functools.partial(
        jax_prefill, cfg=s["jcfg"], ecfg=s["jspec"], mode="infer",
        max_cache_len=L))(s["params"], s["rp"], as_jax(batch), policy=jp)
    tl, tc = prefill(s["tparams"], s["trp"], as_torch(batch), cfg,
                     s["tspec"], mode="infer", max_cache_len=L, policy=tp)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _check_caches(jc, tc, cfg)
    if arch == "gemma3-27b":
        ring = tc["layers"][0]["attn"]["pos"]
        assert ring.shape[1] == 16 and int(ring.max()) == 19
    carried = caches_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                device="cpu")
    jstep = jax.jit(functools.partial(jax_decode_step, cfg=s["jcfg"],
                                      ecfg=s["jspec"], mode="infer"))
    t = np.asarray([20, 20], np.int32)
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
    """tests/test_models_smoke.py's check on the port (Grok-1 at a
    capacity factor that drops no token, as there), and the base forward
    is JAX's."""
    s = _pair(arch)
    cfg, jcfg = s["tcfg"], s["jcfg"]
    if cfg.moe is not None:
        cap = lambda c: dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.n_experts)))
        cfg, jcfg = cap(cfg), cap(jcfg)
    B, S, n_dec = 2, 24, 6
    toks = _tokens(cfg, B, S, 3)
    full, _ = forward(s["tparams"], None, as_torch({"tokens": toks}), cfg,
                      None, mode="base")
    jfull, _ = jax_forward(s["params"], None, as_jax({"tokens": toks}), jcfg,
                           None, mode="base")
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
    """40 greedy steps past Gemma-3's window of 16 (64-slot max_seq, local
    rings of 16): logits every step and the final caches against JAX."""
    s = _pair("gemma3-27b")
    cfg = s["tcfg"]
    toks = _tokens(cfg, 1, 8, 4)
    jl, jc = jax_prefill(s["params"], None, as_jax({"tokens": toks}),
                         s["jcfg"], None, mode="base", max_cache_len=64)
    tl, tc = prefill(s["tparams"], None, as_torch({"tokens": toks}), cfg,
                     None, mode="base", max_cache_len=64)
    jstep = jax.jit(functools.partial(jax_decode_step, cfg=s["jcfg"],
                                      ecfg=None, mode="base"))
    for t in range(8, 48):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert int(_np(tl).argmax(-1)[0]) == int(tok[0, 0])
        jl, jc = jstep(s["params"], None, jnp.asarray(tok), jc, jnp.int32(t))
        tl, tc = decode_step(s["tparams"], None, torch.from_numpy(tok), tc,
                             torch.tensor(t, dtype=torch.int32), cfg, None,
                             mode="base")
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _check_caches(jc, tc, cfg)
    assert int(tc["layers"][0]["attn"]["pos"].min()) == 47 - 15


@pytest.mark.parametrize("arch", ARCHS)
def test_solve_budget_matches_jax(arch):
    """Windows shorten the attention term of the cost model: the same
    capacities as JAX's solver, full and smoke configs."""
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


@pytest.mark.parametrize("arch", ["gemma3-27b", "grok-1-314b"])
def test_loss_and_router_grads_match_jax(arch, monkeypatch):
    """A distillation step at budget 0.6 with its ragged bucket over 24
    tokens: Gemma-3's local layers run the windowed gathered attention
    (recorded), Grok-1 its expert routers; the loss, metrics and every
    router gradient."""
    s = _pair(arch)
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 24, 7)}
    jp, tp = policies([0.6], cfg, False, s["tspec"])
    bucket = ragged_bucket(tp, 24, spec=s["tspec"])
    assert bucket not in (None, IDENTITY_BUCKET) and bucket == \
        jax_ragged_bucket(jp, 24, spec=s["jspec"])
    lf = jax.jit(jax.value_and_grad(jax_make_loss_fn(s["jcfg"], s["jspec"]),
                                    has_aux=True), static_argnames=("bucket",))
    (jloss, jm), jg = lf(s["rp"], s["params"], as_jax(batch), jp,
                         bucket=bucket)
    from repro.checkpoint.checkpointer import _flatten
    jg = _flatten({"routers": jg})
    n_windowed = []
    real = A.windowed_gathered_attention

    def rec(*a, **kw):
        n_windowed.append(a[4])
        return real(*a, **kw)
    monkeypatch.setattr(A, "windowed_gathered_attention", rec)
    rp = tree_map(lambda t: t.clone().requires_grad_(True), s["trp"])
    loss, m = make_loss_fn(cfg, s["tspec"])(rp, s["tparams"],
                                            as_torch(batch), tp,
                                            bucket=bucket)
    loss.backward()
    if arch == "gemma3-27b":
        assert n_windowed and set(n_windowed) == {16}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    for k in ("distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   **LOSS_TOL, err_msg=k)
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, rp)
    got = layered_to_numpy({}, cfg, s["tspec"], {"routers": grads})
    assert sorted(got) == sorted(jg)
    for key, want in jg.items():
        scale = max(1e-3, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)


# ------------------------------- serving -------------------------------------

# three prompt lengths (each a compile of JAX's engine); 20 is past
# Gemma-3's window of 16: its rings wrap
LENS = (8, 20, 12, 20, 8)


def _workload(cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in LENS]


@pytest.fixture(scope="module")
def engine_runs():
    return engine_runs_for(ARCHS, _pair, _workload)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_caches_match_jax(engine_runs, arch):
    run = engine_runs[arch]
    run["margins"].check()
    assert run["got"] == run["want"]
    _check_caches(run["jax_caches"], run["port_caches"], run["cfg"])


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_budget_one_is_the_teacher_bit_for_bit(engine_runs, arch):
    """The engine's budget-1.0 requests give a base engine's tokens, and a
    budget-1.0 row of a mixed forward is the teacher's bit for bit."""
    s = _pair(arch)
    cfg = s["tcfg"]
    batch = as_torch({"tokens": _tokens(cfg, 2, 20, 11)})
    base, _ = forward(s["tparams"], s["trp"], batch, cfg, s["tspec"],
                      mode="base")
    _, tp = policies([1.0, 0.5], cfg)
    mixed, _ = forward(s["tparams"], s["trp"], batch, cfg, s["tspec"],
                       mode="infer", policy=tp)
    assert torch.equal(mixed[0], base[0])
    assert not torch.equal(mixed[1], base[1])
    got = engine_runs[arch]["got"]
    want = _staggered(_port_engine(s, mode="base"), GenRequest,
                      _workload(cfg), BUDGETS)
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


@pytest.mark.parametrize("arch,match", [
    ("gemma3-27b", "sliding-window"), ("grok-1-314b", "dense MLP")])
def test_paged_layout_refusals(arch, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(_pair(arch), kv_layout="paged", page_size=8)


@pytest.mark.parametrize("arch", ["gemma3-27b", "grok-1-314b"])
def test_params_and_routers_round_trip(arch):
    """Grok-1's native expert stacks and expert routers, Gemma-3's tied
    embedding: carried from JAX and back bit for bit."""
    s = _pair(arch)
    back = params_to_numpy(s["tparams"], s["trp"], s["tcfg"], s["tspec"])
    assert sorted(back) == sorted(s["flat"])
    for k, v in s["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if arch == "grok-1-314b":
        assert any(k.endswith("['expert']['w']") for k in back)
        assert any(k.endswith("['mlp']['wg']") for k in back)
