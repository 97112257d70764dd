"""Expert routing of the port against the JAX package, on the CPU in f32:
moefy, the ``moe_gmm`` plain version, ``moe_apply``/``moe_decode``, and
the moefied toy-lm and the native ``qwen2-moe-a2.7b`` smoke config through
forward, the distillation loss and the serving engine.

The JAX side runs its jnp oracles (``kernel_backend="ref"``), and its
Pallas ``moe_gmm`` in interpret mode where the kernel itself is compared;
the port runs its kernels' plain versions (CPU tensors). Inputs come from
numpy seeds. Tolerances, each from summing the same f32 products in
another order:
  * moefy: bit-exact, and the moefied weights are views of the dense ones;
  * ``moe_gmm_ref`` vs JAX ``moe_gmm`` / ``ref.moe_gmm_ref``, and
    ``moe_apply`` / ``moe_decode`` outputs and load aux: rtol=atol=1e-5;
  * ``KernelOp`` around ``moe_gmm``: ``gradcheck`` in f64 (eps and atol
    1e-6) and gradients equal to plain autograd's within 1e-12;
  * model logits rtol=atol=1e-5; RouteAux terms, losses and metrics
    rtol=atol=1e-4; router gradients rtol=1e-3 plus 1e-4 of each leaf's
    largest gradient (the tolerances of tests/test_torch_train.py);
  * the moefied model at budget 1.0 against the dense teacher: atol 1e-5
    (it sums E partial products: not bit-exact, as in the JAX package's
    tests/test_moefy.py);
  * greedy tokens of the serving engines: equal; staggered == solo inside
    the port: equal.
The routing decisions (token top-k, head top-k, expert top-k and expert
capacity) are held equal through ``sel_rate`` and the load aux, and by the
uniform-router cases where every expert weight ties.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten, _unflatten_into  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_elastic as jax_get_elastic  # noqa: E402
from repro.core.moefy import moefy_mlp as jax_moefy  # noqa: E402
from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import ElasticSpec as JaxSpec  # noqa: E402
from repro.core.policy import ragged_bucket as jax_ragged_bucket  # noqa: E402
from repro.core.policy import spec_from_config as jax_spec_from_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import model_init as jax_model_init  # noqa: E402
from repro.models import router_init as jax_router_init  # noqa: E402
from repro.models.moe import moe_apply as jax_moe_apply  # noqa: E402
from repro.models.moe import moe_decode as jax_moe_decode  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.configs import get_config, get_elastic  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.core.moefy import moefy_mlp, unmoefy_mlp  # noqa: E402
from repro_torch.core.policy import (ElasticPolicy, ElasticSpec,  # noqa: E402
                                     ragged_bucket, spec_from_config)
from repro_torch.interop import (layered_to_numpy, params_from_numpy,  # noqa: E402
                                 params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import moe_gmm_ref  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_decode  # noqa: E402
from repro_torch.optim.optimizer import tree_map  # noqa: E402
from repro_torch.training import (GenRequest, ServingEngine,  # noqa: E402
                                  make_loss_fn)
from tests.test_torch_interop import SPEC_KW, RouterMargins  # noqa: E402
from tests.test_torch_routing import _check_kernel_op, _f64  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-4, atol=1e-4)
S = 64
ARCHS = ("toy-moefied", "qwen2-moe")


# ------------------------------ set-up ---------------------------------------

def _specs(arch):
    """(JAX spec, port spec, JAX cfg, port cfg, experts, heads) in f32."""
    if arch == "toy-moefied":
        name, kw = "toy-lm", dict(SPEC_KW, mlp_n_experts=4,
                                  expert_routed=True)
        jspec, tspec = JaxSpec(**kw), ElasticSpec(**kw)
    else:   # the native MoE with its registered elastic config
        name = "qwen2-moe-a2.7b"
        jspec = jax_spec_from_config(jax_get_elastic(
            name, jax_get_config(name, "smoke")))
        tspec = spec_from_config(get_elastic(name, get_config(name, "smoke")))
    jcfg = dataclasses.replace(jax_get_config(name, "smoke"), dtype="float32")
    tcfg = dataclasses.replace(get_config(name, "smoke"), dtype="float32")
    jspec = dataclasses.replace(jspec, kernel_backend="ref")
    n_exp = tcfg.moe.n_experts if tcfg.moe is not None else tspec.mlp_n_experts
    return jspec, tspec, jcfg, tcfg, n_exp, tcfg.n_heads


@functools.lru_cache(maxsize=None)
def moe_pair(arch, seed=0, dtype="float32"):
    """The arch built by the JAX package and the same weights loaded into
    the port (LoRA B filled with N(0, 0.05) noise so the adapter works)."""
    jspec, tspec, jcfg, tcfg, n_exp, n_heads = _specs(arch)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    key = jax.random.PRNGKey(seed)
    params = jax_model_init(key, jcfg, jspec)
    rp = jax_router_init(jax.random.fold_in(key, 1), jcfg, jspec)
    rng = np.random.default_rng(seed)
    rflat = {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.05
                 if "['lora']" in k and k.endswith("['b']") else v)
             for k, v in _flatten(rp).items()}
    rp = jax.tree.map(jnp.asarray, _unflatten_into(rp, rflat))
    flat = _flatten({"params": params, "routers": rp})
    tparams, trp = params_from_numpy(flat, tcfg, tspec, device="cpu")
    return dict(jcfg=jcfg, jspec=jspec, params=params, rp=rp, flat=flat,
                tcfg=tcfg, tspec=tspec, tparams=tparams, trp=trp,
                n_exp=n_exp, n_heads=n_heads)


def _policies(s, budgets):
    """The same per-row budgets as a JAX and a port policy ((B,) leaves)
    and their ragged bucket (both solvers must agree on it)."""
    kw = dict(n_heads=s["n_heads"], n_experts=s["n_exp"])
    jp = JaxPolicy.stack([JaxPolicy.uniform(b, **kw) for b in budgets])
    tp = ElasticPolicy.stack([ElasticPolicy.uniform(b, **kw)
                              for b in budgets])
    bucket = ragged_bucket(tp, S, spec=s["tspec"])
    assert bucket == jax_ragged_bucket(jp, S, spec=s["jspec"])
    return jp, tp, bucket


def _tokens(s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, s["tcfg"].vocab_size, (2, S)).astype(np.int32)


# ------------------------- configs and the solver ----------------------------

@pytest.mark.parametrize("name,variant,moefied", [
    ("qwen2-moe-a2.7b", "full", False), ("qwen2-moe-a2.7b", "smoke", False),
    ("qwen2-7b", "full", True)])
def test_configs_and_budget_solver_match_jax(name, variant, moefied):
    """The registered config and elastic config, the parameter count and
    the roofline budget solver (native-MoE FLOP terms, expert top-k). An
    arch without a registered elastic config (qwen2-7b) gets the port's
    default from ``get_elastic`` (no experts); its solver is held to the
    JAX package at the JAX default (moefied experts) instead."""
    from repro.core import policy as JP
    from repro_torch.configs import ElasticConfig
    from repro_torch.core import policy as TP
    jcfg, tcfg = jax_get_config(name, variant), get_config(name, variant)
    assert (None if tcfg.moe is None else dataclasses.asdict(tcfg.moe)) == \
        (None if jcfg.moe is None else dataclasses.asdict(jcfg.moe))
    assert tcfg.n_params() == jcfg.n_params()
    je, te = jax_get_elastic(name, jcfg), get_elastic(name, tcfg)
    if moefied:
        assert te.mlp_n_experts is None and not te.mlp_expert_topk
        te = ElasticConfig(**{f: getattr(je, f)
                              for f in dataclasses.asdict(te)})
    assert dataclasses.asdict(te) == {f: getattr(je, f)
                                      for f in dataclasses.asdict(te)}
    js, ts = jax_spec_from_config(je), spec_from_config(te)
    if moefied:
        js = dataclasses.replace(js, mlp_n_experts=8)
        ts = dataclasses.replace(ts, mlp_n_experts=8)
    assert TP.stack_flops_per_token(tcfg, ts) == \
        JP.stack_flops_per_token(jcfg, js)
    for b in (0.3, 0.5, 0.75, 1.0):
        tp, jp = TP.solve_budget(tcfg, ts, b), JP.solve_budget(jcfg, js, b)
        for f in dataclasses.fields(tp):
            assert float(getattr(tp, f.name)) == \
                pytest.approx(float(getattr(jp, f.name)), rel=1e-6), f.name


# ------------------------------- moefy ---------------------------------------

def test_moefy_round_trip_returns_views():
    rng = np.random.default_rng(0)
    dense = {k: rng.standard_normal(shape).astype(np.float32)
             for k, shape in (("wi", (16, 24)), ("wg", (16, 24)),
                              ("wo", (24, 16)))}
    tp = {k: torch.from_numpy(v) for k, v in dense.items()}
    ep = moefy_mlp(tp, 4)
    want = jax_moefy({k: jnp.asarray(v) for k, v in dense.items()}, 4)
    for k in dense:
        np.testing.assert_array_equal(ep[k].numpy(), np.asarray(want[k]))
        assert ep[k].untyped_storage().data_ptr() == \
            tp[k].untyped_storage().data_ptr(), k     # a view, not a copy
    assert ep["wi"].stride() == (6, 24, 1)             # expert e: columns
    back = unmoefy_mlp(ep)
    for k in dense:
        assert torch.equal(back[k], tp[k])
        assert back[k].data_ptr() == tp[k].data_ptr()


# ----------------------------- moe_gmm plain --------------------------------

GMM_CASES = [
    # B (None = unbatched), E, C, D, Fe, gated, weighted, counts
    (None, 3, 16, 32, 48, True, False, None),
    (None, 3, 16, 32, 48, True, True, [16, 5, 0]),
    (2, 4, 16, 32, 32, True, True, [[16, 0, 7, 16], [1, 16, 0, 9]]),
    (2, 2, 8, 16, 64, False, False, [[8, 3], [0, 8]]),
]


@pytest.mark.parametrize("case", GMM_CASES, ids=range(len(GMM_CASES)))
def test_moe_gmm_plain_matches_jax(case):
    B, E, C, D, Fe, gated, weighted, counts = case
    lead = (E, C) if B is None else (B, E, C)
    rng = np.random.default_rng(len(lead) + E)
    x = rng.standard_normal(lead + (D,)).astype(np.float32)
    wi = rng.standard_normal((E, D, Fe)).astype(np.float32) * 0.1
    wo = rng.standard_normal((E, Fe, D)).astype(np.float32) * 0.1
    wg = rng.standard_normal((E, D, Fe)).astype(np.float32) * 0.1 \
        if gated else None
    w = rng.random(lead).astype(np.float32) if weighted else None
    cnt = None if counts is None else np.asarray(counts, np.int32)
    act = "swiglu" if gated else "gelu"
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = moe_gmm_ref(t(x), t(wi), t(wo), t(wg), t(w), act=act,
                      group_counts=t(cnt)).numpy()
    want_kernel = np.asarray(jax_moe_gmm(j(x), j(wi), j(wo), j(wg), j(w),
                                         act=act, group_counts=j(cnt),
                                         interpret=True))
    want_ref = np.asarray(jax_ref.moe_gmm_ref(j(x), j(wi), j(wo), j(wg),
                                              j(w), act=act,
                                              group_counts=j(cnt)))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    if cnt is not None:     # slots at or past a count are exact zeros
        live = np.arange(C) < np.broadcast_to(cnt, lead[:-1])[..., None]
        assert not got[~live].any()
    # CPU tensors take the plain version and count no launch
    ops.reset_launch_counts()
    assert torch.equal(ops.moe_gmm(t(x), t(wi), t(wo), t(wg), t(w), t(cnt),
                                   act=act), torch.from_numpy(got))
    assert ops.launch_counts()["moe_gmm"] == 0


BF16_TOL = dict(rtol=1e-2, atol=1e-2)   # chip_smoke.py's bf16 TOL


def _gmm_tc_emulation(x, wi, wo, wg, w, cnt, act):
    """What the tensor-core body of moe_gmm computes, on the CPU: per live
    group, f32 products of the bf16 slots and the expert's bf16 weights
    (read through the given views), act(x wg) * (x wi) rounded to bf16 (the
    bf16 H scratch), an f32 down product, the routing weight, bf16 out;
    exact zeros past each count."""
    import torch.nn.functional as F
    f = F.silu if act == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    B, E, C, D = x.shape
    out = torch.zeros(B, E, C, D)
    for b in range(B):
        for e in range(E):
            c = int(cnt[b, e])
            xs = x[b, e, :c].float()
            h = xs @ wi[e].float()
            h = f(xs @ wg[e].float()) * h if wg is not None else f(h)
            y = h.to(torch.bfloat16).float() @ wo[e].float()
            out[b, e, :c] = y * w[b, e, :c, None] if w is not None else y
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("layout", ["moefied", "native"])
@pytest.mark.parametrize("act,gated", [("swiglu", True), ("gelu", False)])
def test_bf16_grouped_hidden_matches_pallas(layout, act, gated):
    """The tensor-core body of moe_gmm rounds the hidden H to bf16 between
    its phases (the wgmma A operand); the JAX kernel keeps it in f32. An
    emulation of that body, reading the expert weights through the layout
    the kernel reads in place (moefied views of dense matrices, whose Fe =
    192 makes the last 128-column tile straddle into the next expert, or
    native stacks), agrees with the JAX moe_gmm run in interpret mode on
    the same numpy-seeded bf16 inputs within the bf16 tolerance the card
    holds the kernel to (rtol = atol = 1e-2); ragged counts, one empty
    group, slots past each count exactly zero."""
    B, E, C, D, Fe = 2, 3, 96, 128, 192
    rng = np.random.default_rng(31)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x = bf(rng.standard_normal((B, E, C, D)))
    if layout == "moefied":
        dense = {"wi": bf(rng.standard_normal((D, E * Fe)) / D ** 0.5),
                 "wg": bf(rng.standard_normal((D, E * Fe)) / D ** 0.5),
                 "wo": bf(rng.standard_normal((E * Fe, D)) / Fe ** 0.5)}
        ep = moefy_mlp(dense, E)
        wi, wg, wo = ep["wi"], ep["wg"], ep["wo"]
        assert not wi.is_contiguous()
    else:
        wi = bf(rng.standard_normal((E, D, Fe)) / D ** 0.5)
        wg = bf(rng.standard_normal((E, D, Fe)) / D ** 0.5)
        wo = bf(rng.standard_normal((E, Fe, D)) / Fe ** 0.5)
    wg = wg if gated else None
    w = torch.from_numpy(rng.random((B, E, C)).astype(np.float32))
    cnt = np.asarray([[96, 0, 37], [1, 64, 95]], np.int32)
    j = lambda t: None if t is None else jnp.asarray(
        t.float().contiguous().numpy(), jnp.bfloat16)
    want = np.asarray(jax_moe_gmm(
        j(x), j(wi), j(wo), j(wg), jnp.asarray(w.numpy()), act=act,
        group_counts=jnp.asarray(cnt), interpret=True).astype(jnp.float32))
    got = _gmm_tc_emulation(x, wi, wo, wg, w, cnt, act).float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    live = np.arange(C) < cnt[..., None]
    assert not got[~live].any() and not want[~live].any()


def test_kernel_op_moe_gmm_gradients():
    rng = np.random.default_rng(5)
    x, w = _f64(rng, 2, 3, 4, 6), _f64(rng, 2, 3, 4)
    wi, wg, wo = _f64(rng, 3, 6, 5), _f64(rng, 3, 6, 5), _f64(rng, 3, 5, 6)
    cnt = torch.tensor([[4, 0, 2], [1, 4, 3]], dtype=torch.int32)
    plain = lambda x, wi, wo, wg, w, c: moe_gmm_ref(
        x, wi, wo, wg, w, act="swiglu", group_counts=c)
    _check_kernel_op(plain, (x, wi, wo, wg, w, cnt))
    # frozen weights (as on the model path): only x asks for a gradient
    _check_kernel_op(plain, (x, wi.detach(), wo.detach(), wg.detach(), None,
                             cnt))
    # int8 stacks with per-(expert, channel) scales: the plain version on
    # the CPU, the dequantized weights' result
    q8 = lambda w: torch.clamp(torch.round(w.float() * 40), -127, 127).to(
        torch.int8)
    scale = lambda *shape: torch.full(shape, 1 / 40)
    got = ops.moe_gmm(x.float(), q8(wi), q8(wo), q8(wg), w.float(), cnt,
                      wi_scale=scale(3, 5), wo_scale=scale(3, 6),
                      wg_scale=scale(3, 5))
    want = moe_gmm_ref(x.float(), q8(wi).float() / 40, q8(wo).float() / 40,
                       q8(wg).float() / 40, w.float(), act="swiglu",
                       group_counts=cnt)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------- moe_apply / moe_decode ----------------------------

B_, S_, D_, E_, FE_ = 2, 40, 16, 8, 24


def _moe_params(rng, shared=True):
    p = {"router": rng.standard_normal((D_, E_)).astype(np.float32) * 0.5,
         "wi": rng.standard_normal((E_, D_, FE_)).astype(np.float32) * 0.2,
         "wg": rng.standard_normal((E_, D_, FE_)).astype(np.float32) * 0.2,
         "wo": rng.standard_normal((E_, FE_, D_)).astype(np.float32) * 0.2}
    if shared:
        p["shared"] = {
            "wi": rng.standard_normal((D_, 32)).astype(np.float32) * 0.2,
            "wg": rng.standard_normal((D_, 32)).astype(np.float32) * 0.2,
            "wo": rng.standard_normal((32, D_)).astype(np.float32) * 0.2}
    return p


_UNIFORM = np.zeros((D_, E_), np.float32)
MOE_CASES = {
    "static-topk": dict(top_k=2, seq_chunk=16),
    "traced-topk-per-row": dict(top_k=E_, seq_chunk=16, normalize_to_m=True,
                                top_k_traced=np.array([2., 5.], np.float32)),
    "traced-full-row": dict(top_k=E_, seq_chunk=16, normalize_to_m=True,
                            top_k_traced=np.array([8., 3.], np.float32),
                            token_valid=True,
                            dispatch_frac=np.array([.5, .75], np.float32)),
    "valid-static-frac": dict(top_k=3, seq_chunk=64, token_valid=True,
                              dispatch_frac=0.6),
    "token-count-rows": dict(top_k=3, seq_chunk=64,
                             token_count=np.array([30, 17], np.int32)),
    "token-count-int": dict(top_k=3, seq_chunk=16, token_count=25),
    "no-shared": dict(top_k=2, seq_chunk=64, shared=False),
    "uniform-router-static": dict(top_k=2, seq_chunk=16, router_w=_UNIFORM,
                                  normalize_to_m=True),
    "uniform-router-traced": dict(top_k=E_, seq_chunk=16, router_w=_UNIFORM,
                                  normalize_to_m=True,
                                  top_k_traced=np.float32(3.)),
}


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_apply_matches_jax(name):
    """S=40 is not a multiple of a 16-token chunk (padding); every case
    also checks the load aux over real tokens."""
    kw = dict(MOE_CASES[name])
    rng = np.random.default_rng(1)
    p = _moe_params(rng, shared=kw.pop("shared", True))
    x = rng.standard_normal((B_, S_, D_)).astype(np.float32)
    if kw.get("token_valid") is True:
        kw["token_valid"] = rng.random((B_, S_)) < 0.6
    conv = lambda f: {k: f(v) if isinstance(v, (np.ndarray, np.floating))
                      else v for k, v in kw.items()}
    jy, ja = jax_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           act="swiglu", **conv(jnp.asarray))
    ty, ta = moe_apply(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
                       act="swiglu", **conv(torch.as_tensor))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(ta.load), float(ja.load), **TOL)


@pytest.mark.parametrize("kw", [
    dict(top_k=2),                                     # gathered experts
    dict(top_k=E_, normalize_to_m=True,                # every expert once
         top_k_traced=np.array([2., 8.], np.float32)),
    dict(top_k=E_, normalize_to_m=True, router_w=_UNIFORM,
         top_k_traced=np.array([3., 3.], np.float32)),
], ids=["static", "traced", "uniform"])
def test_moe_decode_matches_jax(kw):
    rng = np.random.default_rng(2)
    p = _moe_params(rng)
    x = rng.standard_normal((B_, 1, D_)).astype(np.float32)
    conv = lambda f: {k: f(v) if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()}
    jy, _ = jax_moe_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           act="swiglu", **conv(jnp.asarray))
    ty, _ = moe_decode(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
                       act="swiglu", **conv(torch.as_tensor))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


# ------------------------------- the model -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_train_forward(jcfg, jspec):
    return jax.jit(lambda p, r, b, pol, bucket: jax_forward(
        p, r, b, jcfg, jspec, mode="train", policy=pol, bucket=bucket),
        static_argnames=("bucket",))


@pytest.mark.parametrize("budgets", [
    [1.0, 1.0], [0.75, 0.75], [0.5, 0.5], [0.25, 0.25],
    [0.5, 0.25],          # per-row budgets
    [0.9, 0.9],           # the covering bucket is S: the dense path
], ids=lambda b: "-".join(map(str, b)))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_jax(arch, budgets):
    s = moe_pair(arch)
    jp, tp, bucket = _policies(s, budgets)
    tok = _tokens(s)
    jl, ja = _jax_train_forward(s["jcfg"], s["jspec"])(
        s["params"], s["rp"], {"tokens": jnp.asarray(tok)}, jp,
        bucket=bucket)
    tl, ta = forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(tok)},
                     s["tcfg"], s["tspec"], mode="train", policy=tp,
                     bucket=bucket)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("load", "topk", "sel", "cnt"):
        np.testing.assert_allclose(float(getattr(ta, name)),
                                   float(getattr(ja, name)), **AUX_TOL,
                                   err_msg=name)
    assert float(ta.sel_rate) == pytest.approx(float(ja.sel_rate), abs=1e-6)
    if budgets == [1.0, 1.0] and arch == "toy-moefied":
        # E partial products: the teacher within f32 rounding, not bit-exact
        assert bucket == R.IDENTITY_BUCKET
        base, _ = forward(s["tparams"], s["trp"],
                          {"tokens": torch.from_numpy(tok)}, s["tcfg"],
                          s["tspec"], mode="base")
        np.testing.assert_allclose(tl.numpy(), base.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("mode,budgets", [
    ("base", [1.0, 1.0]), ("infer", [1.0, 1.0]), ("infer", [0.5, 0.25])],
    ids=["base", "infer-1.0", "infer-per-row"])
@pytest.mark.parametrize("arch", ARCHS)
def test_base_and_infer_forward_match_jax(arch, mode, budgets, monkeypatch):
    """The teacher (a native MoE's own top-k router, static capacity) and
    the threshold inference path (the expert router on every token)."""
    s = moe_pair(arch)
    jp, tp, _ = _policies(s, budgets)
    tok = _tokens(s, 2)
    margins = RouterMargins(monkeypatch)
    jl, ja = jax.jit(lambda p, r, b, pol: jax_forward(
        p, r, b, s["jcfg"], s["jspec"], mode=mode, policy=pol))(
        s["params"], s["rp"], {"tokens": jnp.asarray(tok)}, jp)
    tl, ta = forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(tok)},
                     s["tcfg"], s["tspec"], mode=mode, policy=tp)
    if mode == "infer":
        margins.check()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("load", "sel", "cnt"):
        np.testing.assert_allclose(float(getattr(ta, name)),
                                   float(getattr(ja, name)), **AUX_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("budget", [1.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_router_grads_match_jax(arch, budget):
    s = moe_pair(arch)
    jp, tp, bucket = _policies(s, [budget, budget])
    tok = _tokens(s, 1)
    lf = jax_make_loss_fn(s["jcfg"], s["jspec"])
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lf, has_aux=True),
                              static_argnames=("bucket",))(
        s["rp"], s["params"], {"tokens": jnp.asarray(tok)}, jp, bucket=bucket)
    jg = _flatten({"routers": jg})
    rp = tree_map(lambda t: t.clone().requires_grad_(True), s["trp"])
    loss, m = make_loss_fn(s["tcfg"], s["tspec"])(
        rp, s["tparams"], {"tokens": torch.from_numpy(tok)}, tp, bucket)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **AUX_TOL)
    for k in ("distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **AUX_TOL,
                                   err_msg=k)
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, rp)
    got = layered_to_numpy({}, s["tcfg"], s["tspec"], {"routers": grads})
    assert sorted(got) == sorted(jg)
    expert_keys = [k for k in jg if "['expert']" in k]
    assert expert_keys
    for key, want in jg.items():
        scale = max(1e-3, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)
    for key in expert_keys:           # the expert routers are trained
        assert np.abs(got[key]).max() > 0, key


def test_native_trainer_cli_path_on_the_cpu():
    """``launch.train --arch qwen2-moe-a2.7b`` takes the arch's registered
    elastic config (expert routers included)."""
    state, hist, _, _ = train("qwen2-moe-a2.7b", total_steps=2, seq_len=S,
                              global_batch=2, budget=0.5, anneal_from=1.0,
                              anneal_steps=1, device="cpu")
    assert "expert" in state.router_params["layers"][0]
    assert hist[0]["bucket"] == R.IDENTITY_BUCKET
    assert 0 < hist[1]["bucket"] < S
    assert all(np.isfinite(h["loss"]) for h in hist)


# ------------------------------- serving -------------------------------------

BATCH, MAX_SEQ, PLEN, NEW = 3, 48, 12, 6
BUDGETS = [1.0, 0.5, None, 0.75, 0.5]


def _prompts(s):
    rng = np.random.default_rng(3)
    return [rng.integers(0, s["tcfg"].vocab_size, PLEN + 3 * i)
            .astype(np.int32) for i in range(len(BUDGETS))]


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


def _port_engine(s):
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(arch, monkeypatch):
    s = moe_pair(arch, seed=2)
    prompts = _prompts(s)
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ)
    want = _staggered(jeng, JaxRequest, prompts, BUDGETS)
    margins = RouterMargins(monkeypatch)
    got = _staggered(_port_engine(s), GenRequest, prompts, BUDGETS)
    margins.check()
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_equals_solo(arch):
    s = moe_pair(arch, seed=2)
    prompts = _prompts(s)
    stag = _staggered(_port_engine(s), GenRequest, prompts, BUDGETS)
    for i in (1, 3, 4):
        solo = _port_engine(s).generate(
            [GenRequest(prompts[i], NEW, budget=BUDGETS[i])])[0]
        assert list(solo) == stag[i]


# ------------------------------- interop -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_moe_params_and_expert_routers_round_trip(dtype):
    s = moe_pair("qwen2-moe", seed=4, dtype=dtype)
    layer = s["tparams"]["layers"][1]["mlp"]
    E, D, Fe = 8, 64, 48
    assert tuple(layer["wi"].shape) == (E, D, Fe)
    assert tuple(layer["wo"].shape) == (E, Fe, D)
    assert tuple(layer["shared"]["wg"].shape) == (D, 96)
    assert tuple(s["trp"]["layers"][0]["expert"]["w"].shape) == (D, E)
    back = params_to_numpy(s["tparams"], s["trp"], s["tcfg"], s["tspec"])
    assert sorted(back) == sorted(s["flat"])
    for k, want in s["flat"].items():
        if want.dtype.name == "bfloat16":
            assert back[k].dtype == np.float32   # numpy has no bf16: widened
            want = want.astype(np.float32)
        np.testing.assert_array_equal(back[k], want, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_with_expert_routers_round_trip(arch):
    s = moe_pair(arch)
    rng = np.random.default_rng(6)
    jstate = jax_init_state(s["rp"])
    flat = {k: rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in _flatten({"router": jstate.router_params,
                                  "opt_m": jstate.opt.m,
                                  "opt_v": jstate.opt.v}).items()}
    assert any("['expert']" in k for k in flat)
    state = train_state_from_numpy(flat, 5, s["tcfg"], s["tspec"],
                                   device="cpu")
    assert "expert" in state.opt.m["layers"][0]
    back, step = train_state_to_numpy(state, s["tcfg"], s["tspec"])
    assert step == 5 and sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
