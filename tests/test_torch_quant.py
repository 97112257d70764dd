"""Quantized serving of the port (int8 and bf16 KV caches and weights)
against the JAX package's, at toy size in f32, seeded with numpy.

* ``models/quant.py``: int8 codes and f32 scales bit-identical to JAX's on
  the same f32 arrays (exact .5 ties round half to even, all-zero rows get
  scale 1/127), ``quantize_params_tree`` leaf for leaf, input untouched.
* The four kernels' plain versions with int8 operands and scales against
  the JAX Pallas kernels in interpret mode on the same int8 inputs:
  rtol = atol = 1e-5 (f32 sums in other orders).
* One ring and one paged decode step and one prefill chunk on int8 caches
  carried over from JAX (``interop.caches_from_numpy``): logits and the
  written scales within 1e-5; a written code may differ from JAX's by at
  most 1 where the two frameworks' f32 projections straddle a rounding
  boundary (counted and printed).
* The int8/int8 and bf16/bf16 engines, ring and paged: JAX's greedy tokens
  exactly, and the logits of every decode step (and, ring, of every
  admission) within LOGIT_TOL; the final caches' codes within 1 of JAX's
  (the count of differing codes printed).
* Within the port, bit for bit: staggered == solo, budget 1.0 == the int8
  ``mode="base"`` engine, and an int8 fork and a preemption reproducing
  their independent runs (the page copy moves the scale pools verbatim).
* The native MoE's int8 prefill through ``moe_gmm``'s scale operands; a
  moefied MLP with int8 weights raises (the reference drops its scales).

Routing decisions are held equal by seeds whose router logits clear their
thresholds by more than 1e-4 (asserted). The JAX engine runs are shared
through module-scoped fixtures.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jax_decode  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp as jax_fused_mlp  # noqa: E402
from repro.kernels.fused_mlp import \
    fused_mlp_routed as jax_fused_mlp_routed  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.models import cache_init as jax_cache_init  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import quant as JQ  # noqa: E402
from repro.models.model import paged_cache_init as jax_paged_cache_init  # noqa: E402
from repro.models.model import prefill_chunk_step as jax_chunk  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training import serve as jax_serve  # noqa: E402
from repro_torch.core.moefy import moefy_mlp  # noqa: E402
from repro_torch.core.policy import ElasticPolicy  # noqa: E402
from repro_torch.interop import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (fused_mlp_ref,  # noqa: E402
                                     paged_decode_attention_ref)
from repro_torch.models import decode_step, prefill, prefill_chunk_step  # noqa: E402
from repro_torch.models import quant as Q  # noqa: E402
from repro_torch.runtime.pagedkv import copy_page_in_tree  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402
from tests.test_torch_cuda import PAGED_CASES, as_t, paged_inputs, ring  # noqa: E402
from tests.test_torch_interop import RouterMargins, toy_pair  # noqa: E402
from tests.test_torch_kernels import fake_launch  # noqa: E402,F401
from tests.test_torch_moe import moe_pair  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# engine logits, JAX against the port. int8: f32 kernels in other orders,
# plus the rare int8 code that a 1e-7 difference of the projections rounds
# the other way (one code step of one K/V element). bf16 K/V: the JAX
# paged chunk's jnp attention casts its probabilities to V's dtype (one
# bf16 rounding, 2^-8 relative) where the port keeps them in f32, as the
# kernels do (models/attention.py)
LOGIT_TOL = {"int8": dict(rtol=1e-3, atol=1e-3),
             "bf16": dict(rtol=1e-2, atol=1e-2)}
BATCH, MAX_SEQ, PS, NEW = 2, 48, 8, 6
BUDGETS = (1.0, 0.5, None, 0.75)
LENS = (5, 13, 16, 11)
N_HEADS = 4


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    s = toy_pair(seed=0)
    rng = np.random.default_rng(7)
    s["prompts"] = [rng.integers(0, s["tcfg"].vocab_size, n, dtype=np.int64)
                    .astype(np.int32) for n in LENS]
    return s


# ----------------------------- quantization ----------------------------------

def test_quantize_kv_bits_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 9, 4, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                          # all-zero row: scale 1/127
    # exact ties after the division by scale = 127/127 = 1: half to even
    x[1, 1, 1] = 0.0
    x[1, 1, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    jq, js = JQ.quantize_kv(jnp.asarray(x))
    tq, ts = Q.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert float(ts[0, 0, 0]) == np.float32(1.0) / np.float32(127.0)
    assert _np(tq[1, 1, 1, :6]).tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(
        _np(Q.dequantize_kv(tq, ts)), np.asarray(JQ.dequantize_kv(jq, js)))


@pytest.mark.parametrize("shape,axes", [
    ((2, 16, 4, 8), (-3,)),        # stacked wq (L, D, H, Dh)
    ((4, 8, 16), (-3, -2)),        # attention wo (H, Dh, D)
    ((16, 24), (-2,)),             # MLP wi (D, F)
    ((3, 24, 16), (-2,)),          # expert stack wo (E, Fe, D)
])
def test_quantize_weight_bits_match_jax(shape, axes):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                              # some all-zero channels
    jq, js = JQ.quantize_weight(jnp.asarray(w), axes)
    tq, ts = Q.quantize_weight(torch.from_numpy(w), axes)
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        _np(Q.dequantize_weight(tq, ts, axes)),
        np.asarray(JQ.dequantize_weight(jq, js, axes)))


@pytest.mark.parametrize("arch", ["toy-lm", "qwen2-moe"])
@pytest.mark.parametrize("weight_dtype", ["int8", "bf16"])
def test_quantize_params_tree_matches_jax(arch, weight_dtype):
    """Every leaf of the quantized tree, the int8 codes and their scale
    siblings (expert stacks included) bit for bit as JAX's, carried over
    by ``params_from_numpy``; the input tree is not mutated."""
    s = toy_pair(seed=1) if arch == "toy-lm" else moe_pair("qwen2-moe")
    before = {k: v.clone() for k, v in _leaves(s["tparams"]).items()}
    got = Q.quantize_params_tree(s["tparams"], weight_dtype)
    want, _ = params_from_numpy(
        _flatten(JQ.quantize_params_tree(s["params"], weight_dtype)),
        s["tcfg"], s["tspec"], device="cpu")
    gl, wl = _leaves(got), _leaves(want)
    assert sorted(gl) == sorted(wl)
    n_scales = sum(k.endswith("_scale") for k in gl)
    assert (n_scales > 0) == (weight_dtype == "int8")
    for k, w in wl.items():
        g = gl[k]
        assert g.dtype == w.dtype, k
        assert torch.equal(g, w), k
    for k, v in _leaves(s["tparams"]).items():
        assert torch.equal(v, before[k]), f"input leaf {k} changed"


def test_maybe_dequant_and_widened_products_match_jax():
    """``maybe_dequant`` tells the attention ``wo`` from the MLP ``wo`` by
    its sibling names and equals JAX's; the port's products of widened
    codes with scaled output channels equal JAX's products of the
    dequantized weights within 1e-5."""
    rng = np.random.default_rng(8)
    attn = {"wq": rng.standard_normal((16, 4, 8)),
            "wo": rng.standard_normal((4, 8, 16))}
    mlp = {"wi": rng.standard_normal((16, 24)),
           "wo": rng.standard_normal((24, 16))}
    x = rng.standard_normal((3, 16)).astype(np.float32)
    for tree in (attn, mlp):
        tree = {k: v.astype(np.float32) for k, v in tree.items()}
        jq = JQ.quantize_params_tree({k: jnp.asarray(v) for k, v in
                                      tree.items()}, "int8")
        tq = Q.quantize_params_tree({k: torch.from_numpy(v) for k, v in
                                     tree.items()}, "int8")
        for name in tree:
            want = np.asarray(JQ.maybe_dequant(jq, name))
            np.testing.assert_array_equal(_np(Q.maybe_dequant(tq, name)),
                                          want)
        name = "wq" if "wq" in tree else "wi"
        w = Q.widened(tq, name, torch.float32)
        got = Q.scaled(torch.einsum("bd,d...->b...", torch.from_numpy(x), w),
                       tq, name)
        want = np.einsum("bd,d...->b...", x,
                         np.asarray(JQ.maybe_dequant(jq, name)))
        np.testing.assert_allclose(_np(got), want, **TOL)
    assert Q.maybe_dequant(mlp, "wi") is mlp["wi"]     # no scale: as it is


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _leaves(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v for i, sub in enumerate(tree)
                for k2, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_storage_codes_of_the_kernel_wrappers():
    """What the kernels take: the activation dtype, bf16 under f32, int8
    with every scale; anything else raises before a launch."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    t = lambda dt: torch.zeros(2, dtype=dt)
    one = torch.ones(1)
    assert ops.storage_code(f32, [t(f32)], [None], "w") == 0
    assert ops.storage_code(f32, [t(bf16)], [None], "w") == 1
    assert ops.storage_code(bf16, [t(bf16)], [None], "w") == 1
    assert ops.storage_code(bf16, [t(i8), t(i8)], [one, one], "w") == \
        ops.DT_I8
    with pytest.raises(ValueError):
        ops.storage_code(bf16, [t(i8), t(i8)], [one, None], "w")
    with pytest.raises(ValueError):
        ops.storage_code(f32, [t(f32)], [one], "w")
    with pytest.raises(TypeError):
        ops.storage_code(bf16, [t(f32)], [None], "w")
    with pytest.raises(TypeError):
        ops.storage_code(f32, [t(f32), t(bf16)], [None, None], "w")
    assert ops.mlp_plan(bf16, 1, 512, 128, 256).body == "wgmma"
    assert ops.mlp_plan(bf16, 1, 512, 128, 256, weights=i8).body == "wgmma"
    for w in (i8, bf16):          # f32 x: the CUDA-core body
        assert ops.mlp_plan(f32, 1, 512, 128, 256, weights=w).body == \
            "cuda_core"


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_int8_wrappers_hand_the_kernels_codes_and_scales(fake_launch,
                                                         x_dtype):
    """On the kernel path (the library replaced by a recorder, CPU tensors)
    each int8 wrapper launches the entry its plan picks with the int8
    storage code (rt::DT_I8) and the scale pointers, the int8 tensors
    themselves (no widened copy): bf16 x at widths of 64 to the tensor-core
    MLP entries, f32 x to the CUDA-core ones."""
    ops.reset_launch_counts()
    dt = getattr(torch, x_dtype)
    i8 = torch.int8
    D, F, E = 128, 256, 3
    x = torch.zeros(2, 16, D, dtype=dt)
    wi, wg = torch.zeros(D, F, dtype=i8), torch.zeros(D, F, dtype=i8)
    wo = torch.zeros(F, D, dtype=i8)
    sf, sd = torch.ones(F), torch.ones(D)
    ops.fused_mlp(x, wi, wo, wg, wi_scale=sf, wo_scale=sd, wg_scale=sf)
    entry, args = fake_launch.calls[-1]
    if dt == torch.bfloat16:
        assert entry == "fused_mlp_tc_launch" and args[0] == ops.DT_I8
        assert args[3:6] == (wi.data_ptr(), wg.data_ptr(), wo.data_ptr())
        assert None not in args[6:9]
    else:
        assert entry == "fused_mlp_launch" and args[:2] == (0, ops.DT_I8)
        assert args[3:6] == (wi.data_ptr(), wg.data_ptr(), wo.data_ptr())
        assert None not in args[6:9]
    # the routed mode (a train-mode engine's admissions): the same entry
    # points with the gather indices, the code and the three scales
    idx = torch.arange(8).expand(2, 8)
    ops.fused_mlp_routed(x, idx, wi, wo, wg, wi_scale=sf, wo_scale=sd,
                         wg_scale=sf)
    entry, args = fake_launch.calls[-1]
    if dt == torch.bfloat16:
        assert entry == "fused_mlp_tc_launch" and args[0] == ops.DT_I8
        assert args[2] is not None and args[3:6] == (
            wi.data_ptr(), wg.data_ptr(), wo.data_ptr())
        assert None not in args[6:9]
    else:
        assert entry == "fused_mlp_routed_launch"
        assert args[:2] == (0, ops.DT_I8) and args[3] is not None
        assert args[4:7] == (wi.data_ptr(), wg.data_ptr(), wo.data_ptr())
        assert None not in args[7:10]
    assert ops.launch_counts()["fused_mlp_routed"] == 1
    with pytest.raises(ValueError):            # int8 weights without scales
        ops.fused_mlp_routed(x, idx, wi, wo, wg, wi_scale=sf, wo_scale=sd)
    ws = [torch.zeros(E, D, F, dtype=i8), torch.zeros(E, D, F, dtype=i8),
          torch.zeros(E, F, D, dtype=i8)]
    ops.moe_gmm(torch.zeros(1, E, 16, D, dtype=dt), ws[0], ws[2], ws[1],
                None, torch.tensor([[16, 3, 0]]),
                wi_scale=torch.ones(E, F), wo_scale=torch.ones(E, D),
                wg_scale=torch.ones(E, F))
    entry, args = fake_launch.calls[-1]
    assert entry == ("moe_gmm_tc_launch" if dt == torch.bfloat16
                     else "moe_gmm_launch")
    codes = args[:1] if dt == torch.bfloat16 else args[1:2]
    assert codes == (ops.DT_I8,)
    B, L, H, K, Dh = 2, 64, 4, 2, 32
    q = torch.zeros(B, 1, H, Dh, dtype=dt)
    k8 = torch.zeros(B, L, K, Dh, dtype=i8)
    sc = torch.ones(B, L, K)
    ops.decode_attention(q, k8, k8, torch.zeros(B, L, dtype=torch.int32),
                         torch.zeros(B, dtype=torch.int32), None, sc, sc)
    entry, args = fake_launch.calls[-1]
    assert entry == "decode_attention_launch"
    assert args[:3] == (ops._DTYPES[dt], ops.DT_I8, Dh)
    assert args[4] == k8.data_ptr() and None not in args[6:8]
    with pytest.raises(ValueError):            # int8 K/V without scales
        ops.decode_attention(q, k8, k8, torch.zeros(B, L, dtype=torch.int32),
                             torch.zeros(B, dtype=torch.int32))
    assert ops.launch_counts()["decode_attention"] == 1


# ------------------------- plain versions vs Pallas ---------------------------

def _q8(rng, shape, reduce_axes):
    """Random f32 weights quantized by the JAX package: (codes, scales)."""
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    q, s = JQ.quantize_weight(jnp.asarray(w), reduce_axes)
    return np.asarray(q), np.asarray(s)


def test_fused_mlp_plain_int8_matches_pallas():
    rng = np.random.default_rng(2)
    B, T, D, F = 2, 40, 32, 96
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    (wi, wis), (wg, wgs), (wo, wos) = (_q8(rng, (D, F), (-2,)),
                                       _q8(rng, (D, F), (-2,)),
                                       _q8(rng, (F, D), (-2,)))
    tw = rng.random((B, T)).astype(np.float32)
    cnt = np.asarray([40, 17], np.int32)
    want = np.asarray(jax_fused_mlp(
        *(jnp.asarray(a) for a in (x, wi, wo, wg, tw)), act="swiglu",
        valid_count=jnp.asarray(cnt), wi_scale=jnp.asarray(wis),
        wo_scale=jnp.asarray(wos), wg_scale=jnp.asarray(wgs),
        interpret=True))
    got = ops.fused_mlp(*(as_t(a) for a in (x, wi, wo, wg, tw, cnt)),
                        wi_scale=as_t(wis), wo_scale=as_t(wos),
                        wg_scale=as_t(wgs))
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert not _np(got)[1, 17:].any()


@pytest.mark.parametrize("act,gated", [("swiglu", True), ("gelu", False)])
def test_fused_mlp_routed_plain_int8_matches_pallas(act, gated):
    """The routed MLP's plain version on int8 weights with (F,) / (D,)
    scales against the JAX kernel's int8 form in interpret mode: a
    RoutingPlan's layout (the selection ascending, then the rest), an
    empty and a partial count, token weights; unselected rows zero."""
    rng = np.random.default_rng(4)
    B, S, Kb, D, F = 2, 24, 12, 32, 96
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    (wi, wis), (wo, wos) = _q8(rng, (D, F), (-2,)), _q8(rng, (F, D), (-2,))
    wg, wgs = _q8(rng, (D, F), (-2,)) if gated else (None, None)
    cnt = np.asarray([0, 7], np.int32)
    idx = np.stack([np.concatenate([np.sort(p[:c]), np.sort(p[c:Kb])])
                    for p, c in ((rng.permutation(S), c) for c in cnt)])
    idx = idx.astype(np.int32)
    tw = rng.random((B, Kb)).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)
    want = np.asarray(jax_fused_mlp_routed(
        *(j(a) for a in (x, idx, wi, wo, wg, tw)), act=act,
        valid_count=j(cnt), wi_scale=j(wis), wo_scale=j(wos),
        wg_scale=j(wgs), interpret=True))
    t = lambda a: None if a is None else as_t(a)
    got = ops.fused_mlp_routed(*(t(a) for a in (x, idx, wi, wo, wg, tw,
                                                cnt)),
                               wi_scale=t(wis), wo_scale=t(wos),
                               wg_scale=t(wgs), act=act)
    np.testing.assert_allclose(_np(got), want, **TOL)
    live = np.zeros((B, S), bool)
    live[1, idx[1, :7]] = True
    assert not _np(got)[~live].any() and _np(got)[live].any()


def test_moe_gmm_plain_int8_matches_pallas():
    rng = np.random.default_rng(3)
    B, E, C, D, Fe = 2, 3, 16, 32, 64
    x = rng.standard_normal((B, E, C, D)).astype(np.float32)
    (wi, wis), (wg, wgs), (wo, wos) = (_q8(rng, (E, D, Fe), (-2,)),
                                       _q8(rng, (E, D, Fe), (-2,)),
                                       _q8(rng, (E, Fe, D), (-2,)))
    w = rng.random((B, E, C)).astype(np.float32)
    cnt = np.asarray([[16, 5, 0], [9, 16, 1]], np.int32)
    assert wis.shape == (E, Fe) and wos.shape == (E, D)
    want = np.asarray(jax_moe_gmm(
        *(jnp.asarray(a) for a in (x, wi, wo, wg, w)), act="swiglu",
        group_counts=jnp.asarray(cnt), wi_scale=jnp.asarray(wis),
        wo_scale=jnp.asarray(wos), wg_scale=jnp.asarray(wgs),
        interpret=True))
    got = ops.moe_gmm(*(as_t(a) for a in (x, wi, wo, wg, w, cnt)),
                      wi_scale=as_t(wis), wo_scale=as_t(wos),
                      wg_scale=as_t(wgs))
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert not _np(got)[0, 2].any()


def _kv8(k, v):
    """Codes and scales of K and V (JAX's quantizer)."""
    kq, ks = JQ.quantize_kv(jnp.asarray(k))
    vq, vs = JQ.quantize_kv(jnp.asarray(v))
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


@pytest.mark.parametrize("window", [0, 24])
def test_decode_attention_plain_int8_matches_pallas(window):
    B, L, H, K, Dh = 3, 64, 4, 2, 32
    t = np.asarray([20, 63, 90], np.int32)
    k, v, pos, valid = ring(4, B, L, K, Dh, t)
    q = np.random.default_rng(5).standard_normal((B, 1, H, Dh)).astype(
        np.float32)
    kq, vq, ks, vs = _kv8(k, v)
    want = np.asarray(jax_decode(
        *(jnp.asarray(a) for a in (q, kq, vq, pos, t)), window=window,
        kv_valid=jnp.asarray(valid), kscale=jnp.asarray(ks),
        vscale=jnp.asarray(vs), interpret=True))
    got = ops.decode_attention(*(as_t(a) for a in (q, kq, vq, pos, t,
                                                   valid, ks, vs)),
                               window=window)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("case", [0, 1, 4], ids=["holes", "gqa", "chunk"])
def test_paged_plain_int8_matches_pallas(case):
    q, kp, vp, table, t, pvalid = paged_inputs(PAGED_CASES[case], 1)
    kq, vq, ks, vs = _kv8(kp, vp)
    want = np.asarray(jax_paged(
        *(jnp.asarray(a) for a in (q, kq, vq, table, t, pvalid)),
        kscale=jnp.asarray(ks), vscale=jnp.asarray(vs), interpret=True))
    got = ops.paged_decode_attention(
        *(as_t(a) for a in (q, kq, vq, table, t, pvalid, ks, vs)))
    np.testing.assert_allclose(_np(got), want, **TOL)
    dead = (table < 0).all(1)
    assert not _np(got)[dead].any()


def test_bf16_storage_under_f32_plain_versions():
    """bf16 K/V and weights under f32 activations (bf16 storage of an f32
    model): the plain versions widen them exactly, the same as f32 copies."""
    rng = np.random.default_rng(6)
    q, kp, vp, table, t, pvalid = paged_inputs(PAGED_CASES[0], 2)
    b = lambda a: as_t(a).to(torch.bfloat16)
    got = paged_decode_attention_ref(as_t(q), b(kp), b(vp), as_t(table),
                                     as_t(t), as_t(pvalid))
    want = paged_decode_attention_ref(as_t(q), b(kp).float(), b(vp).float(),
                                      as_t(table), as_t(t), as_t(pvalid))
    assert torch.equal(got, want)
    x = as_t(rng.standard_normal((5, 16)).astype(np.float32))
    wi, wo = (b(rng.standard_normal(s).astype(np.float32)) for s in
              ((16, 32), (32, 16)))
    assert torch.equal(fused_mlp_ref(x, wi, wo, act="gelu"),
                       fused_mlp_ref(x, wi.float(), wo.float(), act="gelu"))


# ---------------------- model steps on int8 caches ---------------------------

def _quantized_pair(s):
    """The toy pair's params quantized by JAX, and the same tree carried
    into the port (int8 codes and scale leaves)."""
    jparams = JQ.quantize_params_tree(s["params"], "int8")
    jspec = dataclasses.replace(s["jspec"], kv_dtype="int8",
                                weight_dtype="int8")
    tspec = dataclasses.replace(s["tspec"], kv_dtype="int8",
                                weight_dtype="int8")
    tparams, _ = params_from_numpy(_flatten(jparams), s["tcfg"], tspec,
                                   device="cpu")
    return jparams, jspec, tparams, tspec


def _filled_int8(s, tree, seed):
    """A JAX int8 cache tree with random codes, scales and validity (ring
    ``pos`` left as built by the caller)."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if "scale" in name:
            return (rng.random(a.shape) * 0.05 + 0.01).astype(np.float32)
        if a.dtype == bool:
            return rng.random(a.shape) < 0.8
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


def _codes_within_one(jtree, tc, names):
    """Port caches against a JAX cache tree, layer by layer: codes within
    1 (returns the number that differ), scales within 1e-5, masks equal."""
    n_diff = 0
    for i, layer in enumerate(tc["layers"]):
        ja = jax.tree.map(lambda a: np.asarray(a[i]), jtree["scan"][0])
        for name, leaf in layer["attn"].items():
            got, want = _np(leaf), ja["attn"][name]
            if name in names:
                d = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1, f"layer {i} {name}: codes {d.max()} apart"
                n_diff += int((d > 0).sum())
            elif got.dtype == np.float32:
                np.testing.assert_allclose(got, want, **TOL)
            else:
                np.testing.assert_array_equal(got, want)
    return n_diff


@pytest.mark.parametrize("kind", ["ring", "paged", "chunk"])
def test_step_matches_jax_on_int8_caches(setup, monkeypatch, kind):
    """One ring decode step (3 slots at their own positions), one paged
    decode step (mid-page, page boundary, an inactive slot) or one prefill
    chunk (a final chunk with padding) of the port against JAX's on the
    same int8 caches and int8 weights: logits within 1e-5, the written
    codes within 1 and scales within 1e-5 of JAX's."""
    s = setup
    jparams, jspec, tparams, tspec = _quantized_pair(s)
    margins = RouterMargins(monkeypatch)
    rng = np.random.default_rng(11)
    V = s["tcfg"].vocab_size
    if kind == "ring":
        B, L, t = 3, 32, np.asarray([9, 31, 40], np.int32)
        tree = jax.tree.map(np.asarray, jax_cache_init(s["jcfg"], B, L,
                                                       kv_dtype="int8"))
        tree = _filled_int8(s, tree, 1)
        _, _, pos, _ = ring(2, B, L, 1, 1, t - 1)     # positions up to t - 1
        tree["scan"][0]["attn"]["pos"] = np.broadcast_to(
            pos, tree["scan"][0]["attn"]["pos"].shape).copy()
        kw_j, kw_t = {}, {}
        budgets = [0.5, 1.0, 0.75]
    elif kind == "paged":
        N = 12
        tree = _filled_int8(s, jax.tree.map(np.asarray, jax_paged_cache_init(
            s["jcfg"], N, PS, kv_dtype="int8")), 1)
        table = np.full((3, 4), -1, np.int32)
        table[0, :2] = [7, 2]
        table[1, :3] = [0, 9, 4]
        t = np.asarray([12, 16, 40], np.int32)
        trash = np.full((3,), N - 1, np.int32)
        kw_j = dict(table=jnp.asarray(table), trash=jnp.asarray(trash))
        kw_t = dict(table=torch.from_numpy(table),
                    trash=torch.from_numpy(trash))
        budgets = [0.5, 1.0, 0.75]
    else:
        tree = _filled_int8(s, jax.tree.map(np.asarray, jax_paged_cache_init(
            s["jcfg"], 12, PS, kv_dtype="int8")), 1)
    jc = jax.tree.map(jnp.asarray, tree)
    tc = caches_from_numpy(tree, s["tcfg"], device="cpu")
    assert tc["layers"][0]["attn"]["kscale"].dtype == torch.float32
    if kind in ("ring", "paged"):
        tok = rng.integers(0, V, (3, 1)).astype(np.int32)
        jp = JaxPolicy.stack([JaxPolicy.uniform(b, n_heads=N_HEADS)
                              for b in budgets])
        tp = ElasticPolicy.stack([ElasticPolicy.uniform(b, n_heads=N_HEADS)
                                  for b in budgets])
        jl, jc = jax_decode_step(jparams, s["rp"], jnp.asarray(tok), jc,
                                 jnp.asarray(t), s["jcfg"], jspec,
                                 mode="infer", policy=jp, **kw_j)
        tl, tc = decode_step(tparams, s["trp"], torch.from_numpy(tok), tc,
                             torch.from_numpy(t), s["tcfg"], tspec,
                             mode="infer", policy=tp, **kw_t)
    else:
        row = np.asarray([5, 8, 1, -1, -1, -1, -1, -1], np.int32)
        pos0, plen = 16, 21
        tok = np.zeros((1, PS), np.int32)
        tok[0, :plen - pos0] = rng.integers(0, V, plen - pos0)
        jl, jc = jax_chunk(jparams, s["rp"], jnp.asarray(tok), jc,
                           jnp.int32(1), jnp.asarray(row), jnp.int32(pos0),
                           jnp.int32(plen), s["jcfg"], jspec, mode="infer",
                           policy=JaxPolicy.uniform(0.5, n_heads=N_HEADS))
        tl, tc = prefill_chunk_step(
            tparams, s["trp"], torch.from_numpy(tok), tc, 1,
            torch.from_numpy(row), pos0, plen, s["tcfg"], tspec,
            mode="infer", policy=ElasticPolicy.uniform(0.5, n_heads=N_HEADS))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    names = ("k", "v") if kind == "ring" else ("kp", "vp")
    n = _codes_within_one(jax.tree.map(np.asarray, jc), tc, names)
    print(f"{kind}: {n} written codes differ from JAX's by 1")
    margins.check()


# --------------------------------- engines ------------------------------------

def _staggered(eng, make_req, prompts, budgets=BUDGETS):
    """r0 and r1, two steps, then r2 and r3: admissions land mid-decode."""
    hs = [eng.submit(make_req(p, NEW, budget=b))
          for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(2):
        eng.step()
    hs += [eng.submit(make_req(p, NEW, budget=b))
           for p, b in zip(prompts[2:], budgets[2:])]
    while not all(h.done for h in hs):
        assert eng.step() > 0, "engine stalled"
    return [[int(x) for x in h.output] for h in hs]


def _engine(s, layout, dtype, mode="infer", **kw):
    if layout == "paged":
        kw = {"kv_layout": "paged", "page_size": PS, **kw}
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=BATCH, max_seq=MAX_SEQ,
                         kv_dtype=dtype, weight_dtype=dtype, device="cpu",
                         **kw)


def _jax_engine(s, layout, dtype):
    kw = {"kv_layout": "paged", "page_size": PS} if layout == "paged" else {}
    return JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
                     kv_dtype=dtype, weight_dtype=dtype, **kw)


GRID = [("ring", "int8"), ("paged", "int8"), ("ring", "bf16"),
        ("paged", "bf16")]


@pytest.fixture(scope="module")
def engine_runs(setup):
    """Each (layout, dtype) of GRID served by JAX and by the port (the
    staggered workload), with every sampled row's logits recorded on both
    sides (the rows ``sample_tokens`` sees: admissions, then each decode
    step's slot array) and each engine's final caches."""
    s = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        rec = {}
        jst, tst = jax_serve.sample_tokens, serve_mod.sample_tokens

        def jwrap(logits, *a, **kw):
            jax.debug.callback(lambda lg: rec["jax"].append(np.array(lg)),
                               logits, ordered=True)
            return jst(logits, *a, **kw)

        def twrap(logits, *a, **kw):
            rec["port"].append(_np(logits).copy())
            return tst(logits, *a, **kw)
        mp.setattr(jax_serve, "sample_tokens", jwrap)
        mp.setattr(serve_mod, "sample_tokens", twrap)
        for layout, dtype in GRID:
            rec.update(jax=[], port=[])
            jeng = _jax_engine(s, layout, dtype)
            want = _staggered(jeng, JaxRequest, s["prompts"])
            jax.effects_barrier()
            margins = RouterMargins(mp)
            teng = _engine(s, layout, dtype)
            got = _staggered(teng, GenRequest, s["prompts"])
            out[(layout, dtype)] = dict(
                want=want, got=got, margins=(margins.token, margins.head),
                jax_logits=rec["jax"], port_logits=rec["port"],
                jax_caches=jax.tree.map(np.asarray, jeng._caches),
                port_caches=teng._caches, paged=teng.paged_stats()
                if layout == "paged" else None)
    return out


@pytest.mark.parametrize("layout,dtype", GRID, ids=[f"{a}-{b}" for a, b in
                                                     GRID])
def test_engine_matches_jax_engine(engine_runs, layout, dtype):
    run = engine_runs[(layout, dtype)]
    assert min(run["margins"]) > 1e-4, f"router margins {run['margins']}"
    assert run["got"] == run["want"]
    # decode steps sample (BATCH, V) rows, admissions (1, V); the JAX paged
    # engine samples after every prefill chunk (only the last one's token
    # is kept), the port after the last, so paged admissions are not paired
    split = lambda rows: ([r for r in rows if r.shape[0] == BATCH],
                          [r for r in rows if r.shape[0] != BATCH])
    (jd, ja), (td, ta) = split(run["jax_logits"]), split(run["port_logits"])
    pairs = list(zip(jd, td)) + (list(zip(ja, ta)) if layout == "ring"
                                 else [])
    assert len(jd) == len(td) > 0 and (layout != "ring" or len(ja) == len(ta))
    worst = 0.0
    for a, b in pairs:
        np.testing.assert_allclose(b, a, **LOGIT_TOL[dtype])
        worst = max(worst, float(np.abs(b - a).max()))
    names = ("k", "v") if layout == "ring" else ("kp", "vp")
    if dtype == "int8":
        n = _codes_within_one(run["jax_caches"], run["port_caches"], names)
    else:
        n = 0
        for i, layer in enumerate(run["port_caches"]["layers"]):
            ja = jax.tree.map(lambda a: np.asarray(a[i]),
                              run["jax_caches"]["scan"][0])
            for name in names:
                assert layer["attn"][name].dtype == torch.bfloat16
                # a page written after JAX's bf16-probability chunks: its
                # inputs carry that rounding (LOGIT_TOL), doubled
                np.testing.assert_allclose(
                    _np(layer["attn"][name].float()),
                    np.asarray(ja["attn"][name], np.float32),
                    rtol=2e-2, atol=2e-2)
    if layout == "paged":
        assert run["paged"]["allocated"] == 0
    print(f"{layout} {dtype}: {len(pairs)} sampled logit arrays, largest "
          f"difference {worst:.3e}; {n} cache codes differ from JAX's by 1")


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_int8_staggered_equals_solo(setup, engine_runs, layout):
    s = setup
    stag = engine_runs[(layout, "int8")]["got"]
    for i in (1, 3):
        solo = _engine(s, layout, "int8").generate(
            [GenRequest(s["prompts"][i], NEW, budget=BUDGETS[i])])[0]
        assert list(solo) == stag[i]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_int8_budget_one_equals_int8_base_engine(setup, engine_runs, layout):
    s = setup
    base = _staggered(_engine(s, layout, "int8", mode="base"), GenRequest,
                      s["prompts"], [None] * len(BUDGETS))
    elastic = engine_runs[(layout, "int8")]["got"]
    for i, b in enumerate(BUDGETS):
        if b == 1.0:
            assert elastic[i] == base[i]


def test_int8_fork_reproduces_the_independent_run(setup):
    """A CoW fork on an int8 pool (the tail page's codes and scales copied
    verbatim) continues as an independent run of prompt + output."""
    s = setup
    p = s["prompts"][3]
    eng = _engine(s, "paged", "int8")
    hp = eng.submit(GenRequest(p, 8, budget=0.75))
    for _ in range(3):
        eng.step()
    prefix = list(hp.output)
    assert eng._t[hp.slot] % PS != 0            # a partial tail page
    hc = eng.fork(hp)
    while not (hp.done and hc.done):
        assert eng.step() > 0
    indep = _engine(s, "paged", "int8").generate([GenRequest(
        np.concatenate([p, np.asarray(prefix, np.int32)]), 8 - len(prefix),
        budget=0.75)])[0]
    assert list(hc.output) == list(indep)
    assert eng.paged_stats()["allocated"] == 0


def test_int8_preemption_resumes_exactly(setup):
    """Two requests on a pool one page short: the preempted one re-prefills
    (re-quantizing the same f32 projections to the same bytes) and gives
    its uninterrupted tokens."""
    s = setup
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, s["tcfg"].vocab_size, 20).astype(np.int32)
            for _ in range(2)]
    need = -(-(20 + 12) // PS)
    eng = _engine(s, "paged", "int8", n_pages=2 * need)  # one short + trash
    hs = [eng.submit(GenRequest(p, 12, budget=0.75)) for p in reqs]
    while not all(h.done for h in hs):
        assert eng.step() > 0
    assert eng.n_preempted >= 1
    for h, p in zip(hs, reqs):
        alone = _engine(s, "paged", "int8").generate(
            [GenRequest(p, 12, budget=0.75)])[0]
        assert list(h.output) == list(alone)


def test_copy_page_in_tree_copies_the_scale_pools():
    caches = {"layers": [{"attn": {
        "kp": torch.arange(3 * 4 * 2, dtype=torch.int8).reshape(3, 4, 2, 1),
        "vp": torch.zeros(3, 4, 2, 1, dtype=torch.int8),
        "kscale": torch.rand(3, 4, 2), "vscale": torch.rand(3, 4, 2),
        "pvalid": torch.ones(3, 4, dtype=torch.bool)}}]}
    copy_page_in_tree(caches, 0, 2, 3)
    pool = caches["layers"][0]["attn"]
    for name in ("kp", "vp", "kscale", "vscale"):
        assert torch.equal(pool[name][2], pool[name][0]), name
    assert pool["pvalid"][2].tolist() == [True, True, True, False]


# ---------------------------------- MoE ---------------------------------------

def test_native_moe_int8_prefill_matches_jax(monkeypatch):
    """The native MoE (smoke variant, its registered elastic config) with
    int8 weights and KV: the last-token logits and the ring caches of one
    prefill, through ``moe_gmm``'s scale operands (JAX in interpret
    mode)."""
    s = moe_pair("qwen2-moe")
    jspec = dataclasses.replace(s["jspec"], kernel_backend="interpret",
                                kv_dtype="int8", weight_dtype="int8")
    tspec = dataclasses.replace(s["tspec"], kv_dtype="int8",
                                weight_dtype="int8")
    jparams = JQ.quantize_params_tree(s["params"], "int8")
    tparams = Q.quantize_params_tree(s["tparams"], "int8")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, s["tcfg"].vocab_size, (1, 24)).astype(np.int32)
    jp = JaxPolicy.uniform(0.75, n_heads=s["n_heads"], n_experts=s["n_exp"])
    tp = ElasticPolicy.uniform(0.75, n_heads=s["n_heads"],
                               n_experts=s["n_exp"])
    margins = RouterMargins(monkeypatch)
    calls = []
    real = ops.moe_gmm

    def gmm(*a, **kw):
        calls.append(kw.get("wi_scale"))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "moe_gmm", gmm)
    jl, jc = jax_prefill(jparams, s["rp"], {"tokens": jnp.asarray(tok)},
                         s["jcfg"], jspec, mode="infer", max_cache_len=32,
                         policy=jp)
    tl, tc = prefill(tparams, s["trp"], {"tokens": torch.from_numpy(tok)},
                     s["tcfg"], tspec, mode="infer", max_cache_len=32,
                     policy=tp)
    margins.check()
    assert calls and all(c is not None for c in calls)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    n = _codes_within_one(jax.tree.map(np.asarray, jc), tc, ("k", "v"))
    print(f"native MoE prefill: {n} cache codes differ from JAX's by 1")


def test_moefied_int8_mlp_raises(setup):
    s = setup
    mlp = Q.quantize_params_tree(s["tparams"], "int8")["layers"][0]["mlp"]
    assert "wi_scale" in mlp
    with pytest.raises(NotImplementedError, match="Queue C"):
        moefy_mlp(mlp, 4)
