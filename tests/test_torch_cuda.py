"""The port's hand-written CUDA kernels against their plain PyTorch versions,
and the toy-lm engine on the card. Every test here needs a CUDA device and
nvcc, and skips without them (the kernels have no CPU mode).

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.) The input
cases are shared with tests/test_torch_kernels.py, which holds the plain
versions to the JAX Pallas kernels.

Tolerance on the card: f32 rtol=atol=1e-4 (the kernels sum up to F=512
terms in their own order) and bf16 rtol=atol=2e-2 (both sides round an f32
result to bf16, so they may differ by one bf16 ulp). The training tests
run toy-lm on the card in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

CUDA_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

# Qwen2-7B heads (GQA 7:1, Dh 128) at the training shape, per-row counts
QWEN_TRAIN_FLASH = (2, 512, 512, 28, 4, 128, True, 0, 0.8, [512, 347])

FLASH_CASES = [
    # B, Sq, Sk, H, K, Dh, causal, window, p_valid, count
    (1, 128, 128, 4, 4, 64, True, 0, 1.0, None),       # MHA, all valid
    (2, 256, 256, 8, 2, 64, True, 0, 0.7, None),       # GQA 4:1 + holes
    (2, 128, 128, 4, 2, 32, True, 48, 0.8, None),      # window + holes
    (1, 64, 192, 4, 1, 128, False, 0, 0.9, None),      # MQA, non-causal
    (2, 256, 256, 4, 2, 32, True, 0, 0.6, 100),        # scalar count
    (3, 256, 256, 4, 4, 32, True, 96, 0.7, [7, 130, 256]),  # per-row count
    # Qwen2-7B heads: the training shape and a prompt that is not a
    # multiple of the 64-row tile, with per-row counts
    QWEN_TRAIN_FLASH,
    (2, 300, 300, 28, 4, 128, True, 0, 0.9, [300, 211]),
    # the tensor-core body with a sliding window (tiles before it skipped)
    (2, 320, 320, 8, 2, 128, True, 100, 0.8, [320, 250]),
]

MLP_CASES = [
    # shape of x, F, act, gated, token weights, count
    ((256, 128), 512, "swiglu", True, True, None),
    ((100, 128), 384, "geglu", True, True, None),        # tanh-GELU gate
    ((128, 64), 256, "gelu", False, False, None),        # ungated
    ((300, 64), 256, "swiglu", True, True, 100),         # scalar count
    ((2, 160, 64), 256, "swiglu", True, True, [160, 37]),  # per-row count
]


def as_t(a, **kw):
    t = torch.from_numpy(np.asarray(a))
    return t.to(**kw) if kw else t


def attn_inputs(seed, B, Sq, Sk, H, K, Dh, p_valid):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh), dtype=np.float32)
    k = rng.standard_normal((B, Sk, K, Dh), dtype=np.float32)
    v = rng.standard_normal((B, Sk, K, Dh), dtype=np.float32)
    valid = rng.random((B, Sk)) < p_valid
    return q, k, v, valid


def ring(seed, B, L, K, Dh, t):
    """Ring cache rows written up to per-slot position t (slot = pos % L),
    with never-written (-1) slots and a routing validity mask."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, L, K, Dh), dtype=np.float32)
    v = rng.standard_normal((B, L, K, Dh), dtype=np.float32)
    slots = np.arange(L)[None, :]
    tt = np.asarray(t)[:, None]
    pos = np.where(slots <= tt % L, tt - tt % L, tt - tt % L - L) + slots
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    valid = rng.random((B, L)) < 0.8
    return k, v, pos, valid


PAGED_CASES = [
    # B, N pages, page size, H, K, Dh, table rows, t, pvalid keep fraction
    (3, 10, 8, 4, 2, 32,                       # holes and a -1 row
     [[4, 1, -1, -1], [0, 6, 2, 9], [-1, -1, -1, -1]], [11, 31, 5], 0.8),
    (2, 12, 16, 8, 2, 64,                      # a -1 entry mid-row, GQA 4:1
     [[3, -1, 7, 2], [5, 0, 11, -1]], [55, 15], 0.7),  # 15: page boundary
    (2, 6, 16, 4, 1, 128, [[2, 4], [1, 3]], [20, 31], 0.9),     # MQA
    (4, 9, 16, 28, 4, 128,                     # Qwen2-7B heads, GQA 7:1
     [[8, 3, 0, -1], [1, 5, -1, -1], [-1, -1, -1, -1], [6, 2, 7, 4]],
     [40, 16, 3, 63], 0.8),
    # prefill chunks as attn_chunk calls the kernel: page-size rows share
    # one table row, row i at t = pos0 + i
    (16, 9, 16, 28, 4, 128, [[8, 3, 0, 5]] * 16, list(range(48, 64)), 0.8),
    (16, 5, 16, 8, 2, 64, [[2, -1, -1, -1]] * 16, list(range(16)), 0.7),
    # rows over several 128-key splits of the decode kernel, -1 holes
    (3, 41, 16, 28, 4, 128,
     [[40, 3, 17, 22, 5, 9, 31, 0, 12, -1, 27, 8, 36, 14, 2, 19, 33, 6, 25,
       -1],
      [11, 29, 38, -1, 7, 20, 1, 34, 15] + [-1] * 11,
      [23, 4, 37, 10, 28, 16, 39, 21] + [-1] * 12],
     [300, 129, 127], 0.8),
]


def paged_inputs(case, seed):
    """A paged decode case: q, the pools, table, t and pvalid as numpy.
    Pages are used in shuffled pool order; the second row of the first
    case has its key at t masked through pvalid."""
    B, N, ps, H, K, Dh, table, t, keep = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, Dh), dtype=np.float32)
    kp = rng.standard_normal((N, ps, K, Dh), dtype=np.float32)
    vp = rng.standard_normal((N, ps, K, Dh), dtype=np.float32)
    pvalid = rng.random((N, ps)) < keep
    return (q, kp, vp, np.asarray(table, np.int32), np.asarray(t, np.int32),
            pvalid)


def mlp_inputs(case, seed, **to):
    shape, Fd, act, gated, weighted, count = case
    D = shape[-1]
    rng = np.random.default_rng(seed)
    w = lambda *s: as_t(rng.standard_normal(s, dtype=np.float32) * 0.05,
                        **to)
    x = as_t(rng.standard_normal(shape, dtype=np.float32), **to)
    wi, wo = w(D, Fd), w(Fd, D)
    wg = w(D, Fd) if gated else None
    dev = {"device": to["device"]} if "device" in to else {}
    tw = as_t(rng.random(shape[:-1]).astype(np.float32), **dev) \
        if weighted else None
    cnt = None if count is None else as_t(np.asarray(count, np.int32), **dev)
    return x, wi, wo, wg, tw, cnt, act


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, H, K, Dh, causal, window, p_valid, count = case
    q, k, v, valid = attn_inputs(5, B, Sq, Sk, H, K, Dh, p_valid)
    args = [as_t(a, device=cuda, dtype=dtype) for a in (q, k, v)]
    kw = dict(kv_valid=as_t(valid, device=cuda), causal=causal,
              window=window, kv_count=None if count is None else as_t(
                  np.asarray(count, np.int32), device=cuda))
    n0 = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n0 + 1
    want = ops.flash_attention(*args, backend="ref", **kw)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_decode_kernel_matches_plain(cuda, dtype, window):
    B, L, H, K, Dh = 4, 64, 8, 2, 32
    t = np.asarray([0, 5, 63, 150], np.int32)   # fresh, partial, full, wrapped
    k, v, pos, valid = ring(6, B, L, K, Dh, t)
    valid[0] = False                            # slot 0: no attendable key
    q = np.random.default_rng(7).standard_normal((B, 1, H, Dh),
                                                 dtype=np.float32)
    args = [as_t(a, device=cuda, dtype=dtype) for a in (q, k, v)] + [
        as_t(pos, device=cuda), as_t(t, device=cuda), as_t(valid, device=cuda)]
    got = ops.decode_attention(*args, window=window)
    want = ops.decode_attention(*args, window=window, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=range(len(PAGED_CASES)))
def test_paged_decode_kernel_matches_plain(cuda, case, dtype):
    """Toy and Qwen2-7B head shapes; rows with no attendable key (an
    all -1 row) must be exact zeros."""
    q, kp, vp, table, t, pvalid = paged_inputs(case, 8)
    args = [as_t(a, device=cuda, dtype=dtype) for a in (q, kp, vp)] + [
        as_t(table, device=cuda), as_t(t, device=cuda),
        as_t(pvalid, device=cuda)]
    n0 = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == n0 + 1
    want = ops.paged_decode_attention(*args, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    dead = (table < 0).all(1)
    assert not got[torch.from_numpy(dead).to(cuda)].any()


def long_ring(seed, t, L=1024, H=28, K=4, Dh=128):
    """Qwen2-7B heads over a 1024-slot ring (``ring``) and a query row per
    slot, as numpy."""
    k, v, pos, valid = ring(seed, len(t), L, K, Dh, t)
    q = np.random.default_rng(seed + 1).standard_normal(
        (len(t), 1, H, Dh), dtype=np.float32)
    return q, k, v, pos, np.asarray(t, np.int32), valid


def on_card(arrays, cuda, dtype):
    """q, K/V (and pools) in ``dtype``, the rest as they are, on the card."""
    return [as_t(a, device=cuda, dtype=dtype) if i < 3 else
            as_t(a, device=cuda) for i, a in enumerate(arrays)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_long_ring_matches_plain(cuda, dtype):
    """L=1024 at Qwen2-7B heads: t at the split edges (the plan's split
    size - 1, itself and + 1), a wrapped slot, a slot whose every key is
    masked and an inactive slot (no position written): exact zeros."""
    split = ops.decode_split_plan(1024)[0]
    q, k, v, pos, t, valid = long_ring(
        11, [split - 1, split, split + 1, 1500, 700, 0])
    valid[4] = False
    pos[5] = -1
    args = on_card((q, k, v, pos, t, valid), cuda, dtype)
    n0 = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == n0 + 1
    want = ops.decode_attention(*args, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    assert not got[4:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_slot_ignores_other_slots(cuda, dtype):
    """Ring mode: slot 0's output depends on its own keys only. New K/V,
    positions, t, masks and queries in every other slot, and slot 0 run
    alone (B=1), leave it bit for bit the same: the kernel-level form of
    staggered == solo (the split plan depends on L alone)."""
    q, k, v, pos, t, valid = long_ring(12, [300, 1023, 129, 64])
    base = ops.decode_attention(*on_card((q, k, v, pos, t, valid), cuda,
                                         dtype))
    other = list(long_ring(14, [300, 5, 900, 2047]))
    for new, old in zip(other, (q, k, v, pos, t, valid)):
        new[0] = old[0]
    moved = ops.decode_attention(*on_card(other, cuda, dtype))
    solo = ops.decode_attention(*on_card(
        [a[:1] for a in (q, k, v, pos, t, valid)], cuda, dtype))
    assert torch.equal(moved[0], base[0])
    assert torch.equal(solo[0], base[0])
    assert not torch.equal(moved[1:], base[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_slot_ignores_other_slots(cuda, dtype):
    """Paged mode: slot 0's output depends on its own pages only. Other
    rows pointing at other pages and other t, new K/V and pvalid on every
    page slot 0 does not own, and slot 0 alone (B=1) leave it bit for bit
    the same."""
    q, kp, vp, table, t, pvalid = paged_inputs(PAGED_CASES[-1], 15)
    base = ops.paged_decode_attention(*on_card(
        (q, kp, vp, table, t, pvalid), cuda, dtype))
    rng = np.random.default_rng(16)
    mine = np.unique(table[0][table[0] >= 0])
    free = np.setdiff1d(np.arange(kp.shape[0]), mine)
    table2 = np.full_like(table, -1)
    table2[0] = table[0]
    table2[1, :12] = rng.permutation(free)[:12]
    table2[2, :5] = rng.permutation(free)[:5]
    t2 = np.asarray([t[0], 191, 70], np.int32)
    q2, kp2, vp2 = q.copy(), kp.copy(), vp.copy()
    q2[1:] = rng.standard_normal(q2[1:].shape)
    kp2[free] = rng.standard_normal(kp2[free].shape)
    vp2[free] = rng.standard_normal(vp2[free].shape)
    pvalid2 = pvalid.copy()
    pvalid2[free] = rng.random(pvalid2[free].shape) < 0.5
    moved = ops.paged_decode_attention(*on_card(
        (q2, kp2, vp2, table2, t2, pvalid2), cuda, dtype))
    solo = ops.paged_decode_attention(*on_card(
        (q[:1], kp, vp, table[:1], t[:1], pvalid), cuda, dtype))
    assert torch.equal(moved[0], base[0])
    assert torch.equal(solo[0], base[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_are_deterministic(cuda, dtype):
    """Two calls on the same inputs give the same bits: flash at Qwen2-7B's
    training shape, ring decode over L=1024, paged decode over several
    splits (no atomics; splits merge in a fixed order)."""
    B, Sq, Sk, H, K, Dh, causal, window, p_valid, count = QWEN_TRAIN_FLASH
    q, k, v, valid = attn_inputs(17, B, Sq, Sk, H, K, Dh, p_valid)
    fa = on_card((q, k, v, valid, np.asarray(count, np.int32)), cuda, dtype)
    ring_args = on_card(long_ring(18, [300, 1023, 129, 1500]), cuda, dtype)
    paged_args = on_card(paged_inputs(PAGED_CASES[-1], 19), cuda, dtype)
    for run in (lambda: ops.flash_attention(*fa),
                lambda: ops.decode_attention(*ring_args),
                lambda: ops.paged_decode_attention(*paged_args)):
        assert torch.equal(run(), run())


# The tensor-core body's edges (bf16 at widths that are multiples of 64;
# ops.mlp_plan): row counts around its 64- and 128-row tiles, alone and
# as two rows of a batch with counts that straddle a tile or are 0; an
# ungated tanh-GELU with column tiles past D and F (F = 320, D = 192); and
# widths that are not multiples of 64, which take the CUDA-core body.
# TC_ONE_PART: enough tiles (D = 1024) for one part of the down phase, whose
# blocks store the output themselves (zeros past a count in a live tile and
# in the dead tiles).
TC_ONE_PART = [
    ((2, 1024, 1024), 256, "swiglu", True, True, [1024, 130]),
    ((2, 832, 1024), 128, "gelu", False, True, [0, 831]),
]
TC_MLP_CASES = [
    *[((T, 128), 256, "swiglu", True, True, None)
      for T in (1, 15, 16, 17, 63, 64, 65, 128, 512)],
    *[((2, T, 128), 256, "swiglu", True, True, [T, c])
      for T, c in ((1, 0), (15, 7), (16, 0), (17, 16), (63, 62), (64, 0),
                   (65, 64), (128, 65), (512, 129))],
    ((2, 130, 192), 320, "gelu", False, False, [130, 70]),
    ((70, 96), 160, "swiglu", True, True, None),
    *TC_ONE_PART,
]


def mlp_body(x, wi):
    """The body ``ops.mlp_plan`` picks for a fused_mlp call on x."""
    B, T = (1, *x.shape[:1]) if x.dim() == 2 else x.shape[:2]
    return ops.mlp_plan(x.dtype, B, T, x.shape[-1], wi.shape[1]).body


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLP_CASES + TC_MLP_CASES)
def test_fused_mlp_kernel_matches_plain(cuda, case, dtype):
    x, wi, wo, wg, tw, cnt, act = mlp_inputs(case, 8, device=cuda,
                                             dtype=dtype)
    wide = x.shape[-1] % 64 == 0 and wi.shape[1] % 64 == 0
    assert mlp_body(x, wi) == ("wgmma" if dtype == torch.bfloat16 and wide
                               else "cuda_core")
    if dtype == torch.bfloat16 and case in TC_ONE_PART:
        assert ops.mlp_plan(dtype, *x.shape[:2], x.shape[-1],
                            wi.shape[1]).split == 1
    got = ops.fused_mlp(x, wi, wo, wg, tw, cnt, act=act)
    want = ops.fused_mlp(x, wi, wo, wg, tw, cnt, act=act, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    # a fixed summation order: the same inputs give the same bits
    assert torch.equal(got, ops.fused_mlp(x, wi, wo, wg, tw, cnt, act=act))


ROUTED_CASES = [
    # B, S, Kb, D, F, act, gated, counts
    (2, 96, 48, 64, 256, "swiglu", True, [0, 30]),     # empty and partial
    (2, 128, 64, 64, 192, "swiglu", True, [64, 64]),   # full buckets
    (1, 80, 80, 32, 128, "gelu", False, [77]),         # Kb == S, ungated
    (3, 64, 64, 64, 256, "geglu", True, [64, 1, 40]),  # Kb == S, mixed
    # the tensor-core body's edges: 128-row tiles, a row with count 0, a
    # straddled tile, an ungated bucket of 17, a width off the 64 grid
    (2, 300, 130, 128, 256, "swiglu", True, [130, 0]),
    (2, 600, 512, 128, 320, "swiglu", True, [512, 200]),
    (1, 40, 17, 64, 128, "gelu", False, [17]),
    (2, 50, 20, 96, 160, "swiglu", True, [20, 9]),
]


def routed_inputs(case, seed, device, dtype):
    B, S, Kb, D, Fd, act, gated, counts = case
    rng = np.random.default_rng(seed)
    w = lambda *s: as_t(rng.standard_normal(s, dtype=np.float32) * 0.05,
                        device=device, dtype=dtype)
    x = as_t(rng.standard_normal((B, S, D), dtype=np.float32), device=device,
             dtype=dtype)
    # a RoutingPlan's layout: the selected rows ascending, then the rest
    idx = np.stack([np.concatenate([np.sort(p[:c]), np.sort(p[c:Kb])])
                    for p, c in ((rng.permutation(S), c) for c in counts)])
    wi, wo = w(D, Fd), w(Fd, D)
    wg = w(D, Fd) if gated else None
    tw = as_t(rng.random((B, Kb)).astype(np.float32), device=device)
    cnt = as_t(np.asarray(counts, np.int32), device=device)
    return x, as_t(idx, device=device), wi, wo, wg, tw, cnt, act


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ROUTED_CASES)
def test_fused_mlp_routed_kernel_matches_plain(cuda, case, dtype):
    x, idx, wi, wo, wg, tw, cnt, act = routed_inputs(case, 9, cuda, dtype)
    n0 = ops.launch_counts()["fused_mlp_routed"]
    got = ops.fused_mlp_routed(x, idx, wi, wo, wg, tw, cnt, act=act)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mlp_routed"] == n0 + 1
    want = ops.fused_mlp_routed(x, idx, wi, wo, wg, tw, cnt, act=act,
                                backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    # rows outside the live selection are exactly zero
    live = torch.zeros(x.shape[:2], dtype=torch.bool, device=cuda)
    for b, c in enumerate(cnt.tolist()):
        live[b, idx[b, :c]] = True
    assert got[~live].count_nonzero() == 0
    assert torch.equal(got, ops.fused_mlp_routed(x, idx, wi, wo, wg, tw, cnt,
                                                 act=act))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [16, 65, 200])
def test_fused_mlp_row_ignores_other_rows(cuda, dtype, T):
    """Row independence, the kernel-level form of staggered == solo: a
    row's output is bit for bit the same whether the other rows of its
    tile (and call) hold random values or zeros, in dense and routed
    mode."""
    case = ((1, T, 128), 256, "swiglu", True, True, None)
    x, wi, wo, wg, tw, cnt, act = mlp_inputs(case, 11, device=cuda,
                                             dtype=dtype)
    r = T // 2
    alone = torch.zeros_like(x)
    alone[:, r] = x[:, r]
    full = ops.fused_mlp(x, wi, wo, wg, tw, act=act)
    solo = ops.fused_mlp(alone, wi, wo, wg, tw, act=act)
    assert torch.equal(full[:, r], solo[:, r])
    xs, idx, wi, wo, wg, tw, cnt, act = routed_inputs(
        (1, 2 * T, T, 128, 256, "swiglu", True, [T]), 12, cuda, dtype)
    row = idx[0, r]
    alone = torch.zeros_like(xs)
    alone[0, row] = xs[0, row]
    full = ops.fused_mlp_routed(xs, idx, wi, wo, wg, tw, cnt, act=act)
    solo = ops.fused_mlp_routed(alone, idx, wi, wo, wg, tw, cnt, act=act)
    assert torch.equal(full[0, row], solo[0, row])


def _toy_train_setup(cuda, dtype="float32"):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    cfg = dataclasses.replace(get_config("toy-lm"), dtype=dtype)
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    for layer in rp["layers"]:          # a LoRA that does work
        for ab in layer["lora"].values():
            ab["b"].normal_(0.0, 0.05, generator=gen)
    return cfg, spec, params, rp


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0.75, 0.5])
def test_kernel_path_router_grads_match_plain(cuda, budget):
    """The router gradients through the kernels (autograd.Functions that
    replay the plain versions) equal the plain path's, within 1e-3 of each
    leaf's largest gradient (f32; the forward sums differ in order), and no
    leaf is zero on one path only. Routed budgets only: at budget 1.0 the
    head router's gradient is zero in exact arithmetic (every head is
    kept), and both paths return f32 noise of ~1e-8 there."""
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.training import make_loss_fn
    cfg, spec, params, rp = _toy_train_setup(cuda)
    pol = ElasticPolicy.uniform(budget, n_heads=cfg.n_heads).to(cuda)
    bucket = ragged_bucket(pol, 64)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    grads = {}
    for backend in ("cuda", "ref"):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          rp)
        sp = dataclasses.replace(spec, kernel_backend=backend)
        loss, _ = make_loss_fn(cfg, sp)(leaves, params, {"tokens": tokens},
                                        pol, bucket)
        grads[backend] = torch.autograd.grad(loss, tree_leaves(leaves),
                                             allow_unused=True)
    for a, b in zip(grads["cuda"], grads["ref"]):
        if b is None:
            assert a is None
            continue
        scale = float(b.abs().max())
        assert (float(a.abs().max()) > 0) == (scale > 0)
        assert float((a - b).abs().max()) <= 1e-3 * max(scale, 1e-12)


@pytest.mark.cuda
def test_toy_trainer_three_steps_on_the_card(cuda):
    """launch.train on the card: three annealed steps, the first on the
    identity path (distill exactly 0), all finite, every training kernel
    launched."""
    from repro_torch.core import routing as R
    from repro_torch.launch.train import train
    ops.reset_launch_counts()
    state, hist = train("toy-lm", total_steps=3, seq_len=64, global_batch=2,
                        budget=0.5, anneal_from=1.0, anneal_steps=2,
                        device=cuda)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("flash_attention", "fused_mlp",
                                       "fused_mlp_routed")), counts
    assert hist[0]["bucket"] == R.IDENTITY_BUCKET
    assert hist[0]["distill"] == 0.0
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert int(state.opt.step) == 3


@pytest.mark.cuda
def test_toy_engine_on_the_card(cuda):
    """toy-lm served on the card: every kernel launches, budget 1.0 equals
    the teacher and a request alone equals its staggered run, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16")
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       6, budget=b)
            for n, b in zip((9, 33, 17, 70), (1.0, 0.5, 0.75, 1.0))]
    mk = lambda mode: ServingEngine(params, rp, cfg, spec, mode=mode,
                                    batch_size=2, max_seq=128, device=cuda)
    ops.reset_launch_counts()
    out = mk("infer").generate(reqs)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("flash_attention", "fused_mlp",
                                       "decode_attention")), counts
    base = mk("base").generate(reqs)
    assert [list(o) for o in out[::3]] == [list(o) for o in base[::3]]
    assert list(mk("infer").generate([reqs[2]])[0]) == list(out[2])


GMM_CASES = [
    # layout, B, E, C, D, Fe, act, gated, weighted, counts
    ("moefied", 1, 4, 96, 64, 48, "swiglu", True, False, [[96, 0, 37, 64]]),
    ("moefied", 2, 2, 64, 128, 96, "swiglu", True, True, [[64, 1], [0, 30]]),
    ("native", 1, 6, 20, 64, 88, "swiglu", True, False,
     [[20, 0, 3, 20, 11, 0]]),
    ("native", 2, 3, 70, 32, 64, "gelu", False, True,
     [[70, 65, 0], [2, 70, 64]]),
    # bf16 reaches the tensor-core body at these widths (multiples of 64):
    # a moefied Fe = 192, whose last 128-column tile straddles into the next
    # expert (the last expert's: TMA's zeros); native Fe = 128; C = 44 and
    # 130 around the 64- and 128-row tiles; counts 0, 1, 64 and 128
    ("moefied", 2, 3, 130, 128, 192, "swiglu", True, True,
     [[128, 1, 0], [64, 130, 77]]),
    ("moefied", 1, 4, 44, 64, 192, "gelu", False, False, [[44, 0, 1, 30]]),
    ("native", 1, 4, 44, 64, 128, "swiglu", True, False, [[44, 0, 1, 30]]),
    ("native", 2, 2, 130, 192, 128, "gelu", False, True,
     [[128, 64], [0, 130]]),
    *[(layout, 1, 8, 256, 1024, 256, "swiglu", True, True,
       [[0, 1, 64, 130, 256, 256, 17, 200]])
      for layout in ("moefied", "native")],
]
# the bf16 cases above split the down phase's F reduction (f32 partials and
# a finalize pass); these have the tiles (128) for one part, whose blocks
# store the output themselves
GMM_ONE_PART = GMM_CASES[8:]


def gmm_inputs(case, seed, device, dtype):
    """Dispatch buffers and expert weights in one of the two layouts the
    kernel reads in place: moefied views of dense (D, E*Fe) / (E*Fe, D)
    matrices (strided), or native contiguous (E, D, Fe) / (E, Fe, D)."""
    from repro_torch.core.moefy import moefy_mlp
    layout, B, E, C, D, Fe, act, gated, weighted, counts = case
    rng = np.random.default_rng(seed)
    t = lambda a, **kw: as_t(a.astype(np.float32), device=device, **kw)
    # weights: 0.1 at the narrow widths; at D = 1024 a model's 1/sqrt(fan-in)
    # init (0.1 there gives pre-activations of std 3.2, where the bf16
    # rounding of H alone moves ~0.1 % of the outputs past CUDA_TOL)
    sd_in, sd_out = (0.1, 0.1) if D <= 192 else (D ** -0.5, Fe ** -0.5)
    r = lambda sd, *s: rng.standard_normal(s) * sd
    x = t(rng.standard_normal((B, E, C, D)), dtype=dtype)
    if layout == "moefied":
        dense = {"wi": t(r(sd_in, D, E * Fe), dtype=dtype),
                 "wo": t(r(sd_out, E * Fe, D), dtype=dtype)}
        if gated:
            dense["wg"] = t(r(sd_in, D, E * Fe), dtype=dtype)
        ep = moefy_mlp(dense, E)
        wi, wo, wg = ep["wi"], ep["wo"], ep.get("wg")
        assert not wi.is_contiguous()
    else:
        wi = t(r(sd_in, E, D, Fe), dtype=dtype)
        wo = t(r(sd_out, E, Fe, D), dtype=dtype)
        wg = t(r(sd_in, E, D, Fe), dtype=dtype) if gated else None
    w = t(rng.random((B, E, C))) if weighted else None
    cnt = as_t(np.asarray(counts, np.int32), device=device)
    return x, wi, wo, wg, w, cnt, act


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GMM_CASES, ids=range(len(GMM_CASES)))
def test_moe_gmm_kernel_matches_plain(cuda, case, dtype):
    x, wi, wo, wg, w, cnt, act = gmm_inputs(case, 10, cuda, dtype)
    # the body the plan picks: the tensor cores for bf16 at widths that are
    # multiples of 64, the CUDA cores otherwise
    B, E, C, D = x.shape
    Fe = wi.shape[-1]
    plan = ops.mlp_plan(dtype, B * E, C, D, Fe)
    assert plan.body == ("wgmma" if dtype == torch.bfloat16 and D % 64 == 0
                         and Fe % 64 == 0 else "cuda_core")
    if plan.body == "wgmma":
        assert (plan.split == 1) == (case in GMM_ONE_PART)
    n0 = ops.launch_counts()["moe_gmm"]
    got = ops.moe_gmm(x, wi, wo, wg, w, cnt, act=act)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm"] == n0 + 1
    want = ops.moe_gmm(x, wi, wo, wg, w, cnt, act=act, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    # every slot at or past its group's count is exactly zero
    live = torch.arange(x.shape[2], device=cuda) < cnt[..., None]
    assert got[~live].count_nonzero() == 0
    assert torch.equal(got, ops.moe_gmm(x, wi, wo, wg, w, cnt, act=act))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [GMM_CASES[4], GMM_CASES[7], *GMM_ONE_PART],
                         ids=["moefied", "native", "moefied-one-part",
                              "native-one-part"])
def test_moe_gmm_slot_ignores_other_slots(cuda, case, dtype):
    """Slot independence, the kernel-level form of staggered == solo: a
    slot's output is bit for bit the same whether the other slots of its
    group (and so of its row tile) and the other groups hold random values
    or zeros, at the same counts, on both bodies and both layouts, with the
    down phase split and in one part."""
    case = case[:6] + ("swiglu", True, True, case[9])
    x, wi, wo, wg, w, cnt, act = gmm_inputs(case, 13, cuda, dtype)
    live = [(b, e, int(c)) for (b, e), c in np.ndenumerate(
        cnt.cpu().numpy()) if c > 2]
    for b, e, c in live[:3]:
        r = c // 2          # neither the first nor the last live slot
        alone = torch.zeros_like(x)
        alone[b, e, r] = x[b, e, r]
        full = ops.moe_gmm(x, wi, wo, wg, w, cnt, act=act)
        solo = ops.moe_gmm(alone, wi, wo, wg, w, cnt, act=act)
        assert torch.equal(full[b, e, r], solo[b, e, r])


def _toy_expert_spec():
    from repro_torch.core.policy import ElasticSpec
    return ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1, mlp_n_experts=4,
                       expert_routed=True)


@pytest.mark.cuda
def test_toy_engine_with_experts_on_the_card(cuda):
    """toy-lm moefied into 4 routed experts, served on the card: moe_gmm
    launches, and a request alone equals its staggered run, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16")
    spec = _toy_expert_spec()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(1)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       6, budget=b)
            for n, b in zip((9, 33, 17, 70), (1.0, 0.5, 0.75, 0.5))]
    mk = lambda: ServingEngine(params, rp, cfg, spec, mode="infer",
                               batch_size=2, max_seq=128, device=cuda)
    ops.reset_launch_counts()
    out = mk().generate(reqs)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("flash_attention", "moe_gmm",
                                       "decode_attention")), counts
    for i in (1, 2):
        assert list(mk().generate([reqs[i]])[0]) == list(out[i])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["toy-lm", "qwen2-moe-a2.7b"])
def test_toy_trainer_with_experts_on_the_card(cuda, arch):
    """Three annealed distillation steps on the card with expert routing
    (toy-lm moefied into 4 experts; the native MoE smoke config with its
    registered elastic config): moe_gmm launches, every loss is finite and
    every expert router leaf gets a gradient."""
    from repro_torch.launch import train as T
    ecfg = _toy_expert_spec() if arch == "toy-lm" else None
    cfg, ecfg, params, state, step_fn, pipe = T.build_trainer(
        arch, variant="smoke", total_steps=3, seq_len=64, global_batch=2,
        ecfg=ecfg, device=cuda)
    policy_at = T.policy_schedule(cfg, ecfg, seq_len=64, budget=0.5,
                                  anneal_from=1.0, anneal_steps=2,
                                  total_steps=3, device=cuda)
    ops.reset_launch_counts()
    for i in range(3):
        pol, bucket = policy_at(i)
        batch = {"tokens": torch.as_tensor(pipe.batch_at(i), device=cuda)}
        state, m = step_fn(state, params, batch, pol, bucket)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert ops.launch_counts()["moe_gmm"] > 0
    for layer in state.opt.m["layers"]:   # AdamW's first moment saw a grad
        assert float(layer["expert"]["w"].abs().max()) > 0


@pytest.mark.cuda
def test_toy_paged_engine_on_the_card(cuda):
    """toy-lm served from the paged pool on the card: the paged decode
    kernel and fused_mlp launch, budget 1.0 equals a mode="base" paged
    engine and a request alone equals its staggered run, bit for bit, and
    the pool drains."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16")
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       6, budget=b)
            for n, b in zip((9, 33, 17, 70), (1.0, 0.5, 0.75, 1.0))]
    mk = lambda mode: ServingEngine(params, rp, cfg, spec, mode=mode,
                                    batch_size=2, max_seq=128, device=cuda,
                                    kv_layout="paged", page_size=16)
    ops.reset_launch_counts()
    eng = mk("infer")
    out = eng.generate(reqs)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("paged_decode_attention",
                                       "fused_mlp")), counts
    assert counts["decode_attention"] == 0
    assert eng.paged_stats()["allocated"] == 0
    base = mk("base").generate(reqs)
    assert [list(o) for o in out[::3]] == [list(o) for o in base[::3]]
    assert list(mk("infer").generate([reqs[2]])[0]) == list(out[2])


@pytest.mark.cuda
def test_prng_on_the_card_equals_the_cpu(cuda):
    """core/prng's threefry stream in int64 on the card: keys, bits and
    uniforms equal the CPU's bit for bit; gumbel noise within 4 f32
    epsilons of max(1, |g|) (the two logarithms may round apart)."""
    from repro_torch.core import prng
    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1], dtype=torch.int64)
    pos = torch.tensor([0, 7, 65539, 2 ** 31 - 1], dtype=torch.int32)
    kc = prng.fold_in(prng.PRNGKey(seeds), pos)
    kg = prng.fold_in(prng.PRNGKey(seeds.to(cuda)), pos.to(cuda))
    assert torch.equal(kg.cpu(), kc)
    assert torch.equal(prng.random_bits(kg, 4099).cpu(),
                       prng.random_bits(kc, 4099))
    assert torch.equal(prng.uniform(kg, 4099).cpu(), prng.uniform(kc, 4099))
    gc, gg = prng.gumbel(kc, 4099), prng.gumbel(kg, 4099).cpu()
    eps = torch.finfo(torch.float32).eps
    assert bool(((gg - gc).abs() <= 4 * eps * gc.abs().clamp(min=1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_toy_depth_engine_on_the_card(cuda, layout):
    """toy-lm with the depth router served on the card, greedy and sampled
    requests mixed: the layout's kernels launch, budget-1.0 greedy rows
    equal the teacher, a request alone equals its staggered run bit for
    bit, and the paged pool drains."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16")
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1, depth_routed=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       6, budget=b, temperature=t, top_k=k, seed=s)
            for n, b, t, k, s in zip((9, 33, 17, 70), (1.0, 0.5, 0.75, 1.0),
                                     (0.0, 0.8, 1.0, 0.0), (0, 40, 0, 0),
                                     (0, 3, 4, 0))]
    kw = dict(kv_layout="paged", page_size=16) if layout == "paged" else {}
    mk = lambda mode: ServingEngine(params, rp, cfg, spec, mode=mode,
                                    batch_size=2, max_seq=128, device=cuda,
                                    **kw)
    ops.reset_launch_counts()
    eng = mk("infer")
    out = eng.generate(reqs)
    counts = ops.launch_counts()
    want = (("paged_decode_attention", "fused_mlp") if layout == "paged"
            else ("flash_attention", "fused_mlp", "decode_attention"))
    assert all(counts[k] > 0 for k in want), counts
    base = mk("base").generate([reqs[0], reqs[3]])
    assert [list(o) for o in out[::3]] == [list(o) for o in base]
    for i in (1, 2):
        assert list(mk("infer").generate([reqs[i]])[0]) == list(out[i])
    if layout == "paged":
        assert eng.paged_stats()["allocated"] == 0


# ------------------- quantized operands (int8, bf16 storage) -----------------
#
# The serving engine's int8 K/V (per (key, kv-head) scales) and int8 weights
# (per output channel), and bf16 storage under f32 activations: each kernel
# reads the storage type as it is, against its plain version, which
# dequantizes as q.float() * scale.

def _int8_kv(k, v, cuda):
    from repro_torch.models.quant import quantize_kv
    kq, ks = quantize_kv(as_t(k, device=cuda))
    vq, vs = quantize_kv(as_t(v, device=cuda))
    return kq, vq, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_int8_decode_kernel_matches_plain(cuda, dtype, window):
    B, L, H, K, Dh = 4, 64, 8, 2, 32
    t = np.asarray([0, 5, 63, 150], np.int32)
    k, v, pos, valid = ring(6, B, L, K, Dh, t)
    valid[0] = False                            # slot 0: no attendable key
    q = np.random.default_rng(7).standard_normal((B, 1, H, Dh),
                                                 dtype=np.float32)
    kq, vq, ks, vs = _int8_kv(k, v, cuda)
    args = [as_t(q, device=cuda, dtype=dtype), kq, vq,
            as_t(pos, device=cuda), as_t(t, device=cuda),
            as_t(valid, device=cuda), ks, vs]
    n0 = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == n0 + 1
    want = ops.decode_attention(*args, window=window, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=range(len(PAGED_CASES)))
def test_int8_paged_decode_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, table, t, pvalid = paged_inputs(case, 8)
    kq, vq, ks, vs = _int8_kv(kp, vp, cuda)
    args = [as_t(q, device=cuda, dtype=dtype), kq, vq,
            as_t(table, device=cuda), as_t(t, device=cuda),
            as_t(pvalid, device=cuda), ks, vs]
    got = ops.paged_decode_attention(*args)
    want = ops.paged_decode_attention(*args, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    dead = (table < 0).all(1)
    assert not got[torch.from_numpy(dead).to(cuda)].any()


@pytest.mark.cuda
def test_bf16_kv_under_f32_decode_kernels(cuda):
    """bf16 K/V of an f32 model: the CUDA-core body templated on the
    storage type, against the plain version (which widens exactly)."""
    B, L, H, K, Dh = 3, 64, 8, 2, 64
    t = np.asarray([5, 63, 150], np.int32)
    k, v, pos, valid = ring(9, B, L, K, Dh, t)
    q = np.random.default_rng(3).standard_normal((B, 1, H, Dh),
                                                 dtype=np.float32)
    args = [as_t(q, device=cuda), as_t(k, device=cuda, dtype=torch.bfloat16),
            as_t(v, device=cuda, dtype=torch.bfloat16),
            as_t(pos, device=cuda), as_t(t, device=cuda),
            as_t(valid, device=cuda)]
    got = ops.decode_attention(*args)
    torch.testing.assert_close(got, ops.decode_attention(*args,
                                                         backend="ref"),
                               **CUDA_TOL[torch.float32])
    q, kp, vp, table, t, pvalid = paged_inputs(PAGED_CASES[1], 4)
    args = [as_t(q, device=cuda)] + [
        as_t(a, device=cuda, dtype=torch.bfloat16) for a in (kp, vp)] + [
        as_t(a, device=cuda) for a in (table, t, pvalid)]
    got = ops.paged_decode_attention(*args)
    torch.testing.assert_close(got, ops.paged_decode_attention(
        *args, backend="ref"), **CUDA_TOL[torch.float32])


def _int8_weights(cuda, *ws):
    """Each weight quantized per output channel (its last axis)."""
    from repro_torch.models.quant import quantize_weight
    return [quantize_weight(w.float(), (-2,)) if w is not None else
            (None, None) for w in ws]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLP_CASES + [
    ((1, 16, 256), 512, "swiglu", True, False, None),    # a paged chunk
    ((1, 70, 128), 192, "swiglu", True, True, [41])])
def test_int8_fused_mlp_kernel_matches_plain(cuda, case, dtype):
    x, wi, wo, wg, tw, cnt, act = mlp_inputs(case, 5, device=cuda,
                                             dtype=dtype)
    (wiq, wis), (woq, wos), (wgq, wgs) = _int8_weights(cuda, wi, wo, wg)
    kw = dict(wi_scale=wis, wo_scale=wos, wg_scale=wgs, act=act)
    n0 = ops.launch_counts()["fused_mlp"]
    got = ops.fused_mlp(x, wiq, woq, wgq, tw, cnt, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mlp"] == n0 + 1
    want = ops.fused_mlp(x, wiq, woq, wgq, tw, cnt, backend="ref", **kw)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    assert torch.equal(got, ops.fused_mlp(x, wiq, woq, wgq, tw, cnt, **kw))


@pytest.mark.cuda
def test_bf16_weights_under_f32_fused_mlp(cuda):
    x, wi, wo, wg, tw, cnt, act = mlp_inputs(MLP_CASES[4], 6, device=cuda)
    b = lambda w: w.to(torch.bfloat16)
    got = ops.fused_mlp(x, b(wi), b(wo), b(wg), tw, cnt, act=act)
    want = ops.fused_mlp(x, b(wi), b(wo), b(wg), tw, cnt, act=act,
                         backend="ref")
    torch.testing.assert_close(got, want, **CUDA_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in GMM_CASES if c[0] == "native"],
                         ids=range(5))
def test_int8_moe_gmm_kernel_matches_plain(cuda, case, dtype):
    """Native expert stacks as int8 codes with (E, Fe) / (E, D) scales."""
    x, wi, wo, wg, w, cnt, act = gmm_inputs(case, 10, cuda, dtype)
    (wiq, wis), (woq, wos), (wgq, wgs) = _int8_weights(cuda, wi, wo, wg)
    kw = dict(wi_scale=wis, wo_scale=wos, wg_scale=wgs, act=act)
    got = ops.moe_gmm(x, wiq, woq, wgq, w, cnt, **kw)
    want = ops.moe_gmm(x, wiq, woq, wgq, w, cnt, backend="ref", **kw)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    live = torch.arange(x.shape[2], device=cuda) < cnt[..., None]
    assert got[~live].count_nonzero() == 0
    assert torch.equal(got, ops.moe_gmm(x, wiq, woq, wgq, w, cnt, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ROUTED_CASES)
def test_int8_fused_mlp_routed_kernel_matches_plain(cuda, case, dtype):
    """The routed MLP on int8 weights with (F,) / (D,) scales (a train-mode
    serving engine's admissions): bf16 at widths of 64 on the tensor-core
    body's int8 form (its int8 B tiles beside the cp.async row gather), the
    rest on the CUDA-core body; empty and full buckets among the cases."""
    x, idx, wi, wo, wg, tw, cnt, act = routed_inputs(case, 13, cuda, dtype)
    (wiq, wis), (woq, wos), (wgq, wgs) = _int8_weights(cuda, wi, wo, wg)
    kw = dict(wi_scale=wis, wo_scale=wos, wg_scale=wgs, act=act)
    n0 = ops.launch_counts()["fused_mlp_routed"]
    got = ops.fused_mlp_routed(x, idx, wiq, woq, wgq, tw, cnt, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mlp_routed"] == n0 + 1
    want = ops.fused_mlp_routed(x, idx, wiq, woq, wgq, tw, cnt,
                                backend="ref", **kw)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    live = torch.zeros(x.shape[:2], dtype=torch.bool, device=cuda)
    for b, c in enumerate(cnt.tolist()):
        live[b, idx[b, :c]] = True
    assert got[~live].count_nonzero() == 0
    assert torch.equal(got, ops.fused_mlp_routed(x, idx, wiq, woq, wgq, tw,
                                                 cnt, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [16, 65, 200])
def test_int8_fused_mlp_routed_row_ignores_other_rows(cuda, dtype, T):
    """Staggered == solo at the kernel on int8 weights: a selected row's
    output is the same bits whether the other rows of the stream hold
    random values or zeros."""
    xs, idx, wi, wo, wg, tw, cnt, act = routed_inputs(
        (1, 2 * T, T, 128, 256, "swiglu", True, [T]), 14, cuda, dtype)
    (wiq, wis), (woq, wos), (wgq, wgs) = _int8_weights(cuda, wi, wo, wg)
    kw = dict(wi_scale=wis, wo_scale=wos, wg_scale=wgs, act=act)
    row = idx[0, T // 2]
    alone = torch.zeros_like(xs)
    alone[0, row] = xs[0, row]
    full = ops.fused_mlp_routed(xs, idx, wiq, woq, wgq, tw, cnt, **kw)
    solo = ops.fused_mlp_routed(alone, idx, wiq, woq, wgq, tw, cnt, **kw)
    assert torch.equal(full[0, row], solo[0, row])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("d_ff", [352, 384])
def test_graphed_train_engine_equals_eager_bit_for_bit(cuda, storage, d_ff):
    """A train-mode (top-k) ring engine on toy-lm in bf16 (d_ff 352: the
    routed MLP on the CUDA-core body; 384: on the tensor-core body), int8
    or bf16 weights and K/V: the graphed engine equals its
    ``cuda_graphs=False`` twin (tokens, every cache leaf), the admissions
    launch fused_mlp_routed, budget 1.0 equals the ``mode="base"`` engine
    and a request alone equals its staggered run, bit for bit; one decode
    form, no prefill form."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16",
                              d_ff=d_ff)
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       6, budget=b)
            for n, b in zip((9, 70, 33, 17, 40), (1.0, 0.5, 0.75, 1.0, 0.3))]
    mk = lambda mode="train", graphs=True: ServingEngine(
        params, rp, cfg, spec, mode=mode, batch_size=2, max_seq=128,
        device=cuda, kv_dtype=storage, weight_dtype=storage,
        cuda_graphs=graphs)
    graphed = mk()
    got = _staggered_run(graphed, reqs)
    eager = mk(graphs=False)
    ops.reset_launch_counts()
    want = _staggered_run(eager, reqs)
    counts = ops.launch_counts()
    assert got == want
    for a, b in zip(_tensors(graphed._caches), _tensors(eager._caches)):
        assert torch.equal(a, b)
    assert all(counts[k] > 0 for k in ("flash_attention", "fused_mlp",
                                       "fused_mlp_routed",
                                       "decode_attention")), counts
    assert graphed.compile_counts() == {"prefill": 0, "decode": 1}
    base = _staggered_run(mk("base"), reqs)
    assert [got[0], got[3]] == [base[0], base[3]]
    assert _staggered_run(mk(), [reqs[1]]) == [got[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_toy_int8_engine_on_the_card(cuda, layout):
    """toy-lm (bf16) served with int8 weights and KV: the int8 kernels
    launch, budget 1.0 equals the int8 teacher and a request alone equals
    its staggered run, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16")
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       6, budget=b)
            for n, b in zip((9, 33, 17, 70), (1.0, 0.5, 0.75, 1.0))]
    kw = dict(kv_layout="paged", page_size=16) if layout == "paged" else {}
    mk = lambda mode: ServingEngine(params, rp, cfg, spec, mode=mode,
                                    batch_size=2, max_seq=128, device=cuda,
                                    kv_dtype="int8", weight_dtype="int8",
                                    **kw)
    ops.reset_launch_counts()
    out = mk("infer").generate(reqs)
    counts = ops.launch_counts()
    want = ("fused_mlp", "paged_decode_attention") if layout == "paged" \
        else ("flash_attention", "fused_mlp", "decode_attention")
    assert all(counts[k] > 0 for k in want), counts
    base = mk("base").generate(reqs)
    assert [list(o) for o in out[::3]] == [list(o) for o in base[::3]]
    assert list(mk("infer").generate([reqs[2]])[0]) == list(out[2])


# ------------------- captured entry points (CUDA graphs) ---------------------
#
# The serving engine captures its decode step (greedy-only and sampling
# forms) and, paged, its prefill chunk into CUDA graphs; ``cuda_graphs=False``
# runs the same bodies eagerly. Both must give the same bits.

def _toy_serving(cuda, storage):
    """toy-lm (4 layers) in f32 for "fp32", else bf16, with the slice's
    routers; greedy and sampled requests at mixed budgets. Returns (make
    engine, requests)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.models import model_init, router_init
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype=(
        "float32" if storage == "fp32" else "bfloat16"))
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       new, budget=b, temperature=t, top_k=k, seed=s)
            for n, new, b, t, k, s in (
                (9, 8, 1.0, 0.0, 0, 0), (33, 4, 0.5, 0.8, 40, 3),
                (17, 6, 0.75, 0.0, 0, 0), (70, 5, None, 1.0, 0, 4),
                (40, 6, 0.5, 0.0, 0, 0))]
    q = "int8" if storage == "int8" else "fp32"

    def mk(layout, graphs=True, mode="infer"):
        kw = dict(kv_layout="paged", page_size=16) if layout == "paged" \
            else {}
        return ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=2,
                             max_seq=128, device=cuda, kv_dtype=q,
                             weight_dtype=q, cuda_graphs=graphs, **kw)
    return mk, reqs


def _staggered_run(eng, reqs):
    hs = [eng.submit(r) for r in reqs[:2]]
    eng.step()
    eng.step()
    hs += [eng.submit(r) for r in reqs[2:]]
    while not all(h.done for h in hs):
        assert eng.step() > 0
    return [list(h.output) for h in hs]


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_graphed_engine_equals_eager_bit_for_bit(cuda, layout, storage):
    """The captured entry points against ``cuda_graphs=False`` on the same
    weights and staggered greedy and sampled requests: the same tokens,
    the same caches (every K/V, scale, validity and position leaf) and the
    same page table; each replay counts the kernels it launches."""
    mk, reqs = _toy_serving(cuda, storage)
    ops.reset_launch_counts()
    graphed = mk(layout)
    got = _staggered_run(graphed, reqs)
    counts = ops.launch_counts()
    eager = mk(layout, graphs=False)
    ops.reset_launch_counts()
    want = _staggered_run(eager, reqs)
    assert got == want
    for a, b in zip(_tensors(graphed._caches), _tensors(eager._caches)):
        assert torch.equal(a, b)
    decode = "paged_decode_attention" if layout == "paged" \
        else "decode_attention"
    assert counts[decode] == ops.launch_counts()[decode] > 0
    want_counts = {"prefill": int(layout == "paged"), "decode": 2}
    assert graphed.compile_counts() == eager.compile_counts() == want_counts
    if layout == "paged":
        assert np.array_equal(graphed._table, eager._table)
        assert graphed.paged_stats() == eager.paged_stats()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_graph_counts_stay_flat_on_the_card(cuda, layout):
    """More requests at other budgets, slots and sampling settings on an
    engine whose forms are built add no capture."""
    from repro_torch.training import GenRequest
    mk, reqs = _toy_serving(cuda, "bf16")
    eng = mk(layout)
    _staggered_run(eng, reqs)
    built = eng.compile_counts()
    assert built == {"prefill": int(layout == "paged"), "decode": 2}
    rng = np.random.default_rng(1)
    more = [GenRequest(rng.integers(0, 2048, n).astype(np.int32), 5,
                       budget=b, temperature=t, top_k=k, seed=s)
            for n, b, t, k, s in ((50, 0.25, 0.7, 5, 9), (3, None, 0.0, 0, 0),
                                  (90, 0.9, 0.0, 0, 0),
                                  (16, 0.6, 1.2, 0, 2 ** 32 - 1))]
    _staggered_run(eng, more)
    assert eng.compile_counts() == built


@pytest.mark.cuda
def test_engines_built_and_freed_leave_memory_where_it_was(cuda):
    """Each engine's graphs live in its own pool and go with it: engines
    built, run and freed in turn leave ``memory_reserved`` where the first
    one left it."""
    import gc
    mk, reqs = _toy_serving(cuda, "bf16")
    reserved = []
    for layout in ("paged", "ring", "paged", "ring"):
        eng = mk(layout)
        _staggered_run(eng, reqs)
        del eng
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[2:] == reserved[:2], reserved


@pytest.mark.cuda
def test_host_sync_in_the_body_makes_capture_raise(cuda, monkeypatch):
    """A host read inside the decode body runs in the eager first call and
    fails the capture after it: the engine raises, never falls back."""
    from repro_torch.training import serve as serve_mod
    real = serve_mod.decode_step

    def syncing(*a, **kw):
        logits, caches = real(*a, **kw)
        float(logits.sum())                       # a host read
        return logits, caches
    mk, reqs = _toy_serving(cuda, "bf16")
    monkeypatch.setattr(serve_mod, "decode_step", syncing)
    eng = mk("ring")
    eng.submit(reqs[0])
    with pytest.raises(RuntimeError):
        eng.step()
    torch.cuda.synchronize()
    eager = mk("ring", graphs=False)          # the caller's explicit choice
    assert len(eager.generate([reqs[0]])[0]) == reqs[0].max_new_tokens


# ------------------------- the SLO controller on the card ---------------------
#
# The controller's in-flight and depth stages splice degraded rows into the
# live policy leaves in place; a replayed decode graph must read them, so a
# graphed engine equals its eager twin across a degrade and a restore.

def _toy_controlled(cuda, layout, graphs):
    """toy-lm at 2 layers in bf16 with the depth router, a controller with
    generous targets that restores one stage per evaluation, and a step
    loop on an injected clock that degrades every stage to the floor by
    hand at step 3 (so rows admitted at full budget are spliced down, then
    restored step by step). Returns (engine, tokens, compile_counts()
    before the degrade)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.launch.workloads import StepClock
    from repro_torch.models import model_init, router_init
    from repro_torch.runtime.controller import SLOController, SLOTarget
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="bfloat16",
                              n_layers=2)
    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1, depth_routed=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model_init(gen, cfg, spec, device=cuda)
    rp = router_init(gen, cfg, spec, device=cuda)
    ctrl = SLOController(targets={"default": SLOTarget(p95_ttft_ms=1e6)},
                         floor=0.25, step_up=0.25, eval_interval_s=0.0,
                         patience=1, min_samples=1)
    clock = StepClock(0.1)
    kw = dict(kv_layout="paged", page_size=16) if layout == "paged" else {}
    eng = ServingEngine(params, rp, cfg, spec, mode="infer", batch_size=2,
                        max_seq=128, device=cuda, cuda_graphs=graphs,
                        controller=ctrl, clock=clock, **kw)
    rng = np.random.default_rng(0)
    hs = [eng.submit(GenRequest(rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), 12, budget=b, temperature=t, seed=s))
        for n, b, t, s in ((9, None, 0.0, 0), (33, 0.75, 0.8, 3),
                           (17, None, 0.0, 0), (40, 0.5, 1.0, 4))]
    for i in range(200):
        if i == 3:
            before = eng.compile_counts()
            ctrl.admission_budget = ctrl.depth_budget = \
                ctrl.inflight_budget = 0.25
        clock.tick()
        eng.step()
        if not eng.has_work:
            break
    return eng, [list(h.output) for h in hs], before


def _live_tensors(eng):
    """chip_smoke.py's ``engine_cache_tensors``: the engine's cache leaves,
    a paged pool's without its trash page (checked to be out of every
    table row, freelist and refcount)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.engine_cache_tensors(eng)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_graphed_controller_engine_equals_eager(cuda, layout):
    """Greedy and sampled requests through a degrade of every stage and
    the controller's restores: the graphed engine and its
    ``cuda_graphs=False`` twin give the same tokens, caches, trajectory
    and events, and the graphs built before the degrade are the only
    ones."""
    graphed, got, before = _toy_controlled(cuda, layout, True)
    eager, want, _ = _toy_controlled(cuda, layout, False)
    assert got == want
    for a, b in zip(_live_tensors(graphed), _live_tensors(eager)):
        assert torch.equal(a, b)
    gc, ec = graphed.controller, eager.controller
    assert gc.trajectory == ec.trajectory and gc.events == ec.events
    kinds = [k for _t, k, _v in gc.events]
    assert kinds[:3] == ["restore_inflight"] * 3 and "restore_depth" in kinds
    assert graphed.compile_counts() == eager.compile_counts() == before
    assert before["prefill"] == int(layout == "paged") and before["decode"]


@pytest.mark.cuda
def test_reshard_captures_again_with_identical_tokens(cuda):
    """``reshard(None)`` mid-run on a graphed ring engine drops its graphs
    (``compile_counts()`` back to 0), the next step captures again, and
    every request continues with the tokens of an uninterrupted run."""
    mk, reqs = _toy_serving(cuda, "bf16")
    want = _staggered_run(mk("ring"), reqs)
    eng = mk("ring")
    hs = [eng.submit(r) for r in reqs[:2]]
    eng.step()
    eng.step()
    hs += [eng.submit(r) for r in reqs[2:]]
    eng.step()
    assert eng.compile_counts()["decode"] >= 1
    eng.reshard(None)
    assert eng.compile_counts() == {"prefill": 0, "decode": 0}
    while not all(h.done for h in hs):
        assert eng.step() > 0
    assert [list(h.output) for h in hs] == want
    assert eng.compile_counts()["decode"] >= 1
    with pytest.raises(NotImplementedError, match="item 11"):
        eng.reshard(object())
    with pytest.raises(NotImplementedError):
        mk("paged").reshard(None)
