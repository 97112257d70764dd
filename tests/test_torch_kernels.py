"""The port's kernels: each plain PyTorch version against the JAX Pallas
kernel run in interpret mode (as tests/test_kernels.py runs it). The CUDA
kernels against these plain versions are in tests/test_torch_cuda.py.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
Tolerance: f32 rtol=atol=1e-5 (the same f32 math summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp as jax_fused_mlp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     flash_attention_ref, fused_mlp_ref,
                                     fused_mlp_routed_ref)
from tests.test_torch_cuda import (FLASH_CASES, MLP_CASES, as_t,  # noqa: E402
                                   attn_inputs, mlp_inputs, ring)

TOL = dict(rtol=1e-5, atol=1e-5)


def _attendable(B, Sq, Sk, H, causal, window, valid, count):
    """(B, Sq, H) True where a query row has at least one attendable key."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= (qp - kp) < window
    m = np.broadcast_to(m, (B, Sq, Sk)) & valid[:, None, :]
    cnt = np.broadcast_to(np.asarray(max(Sq, Sk) if count is None
                                     else count).reshape(-1), (B,))
    m = m & (kp[None] < cnt[:, None, None])
    return np.repeat(m.any(-1)[..., None], H, axis=-1)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, Sq, Sk, H, K, Dh, causal, window, p_valid, count = case
    q, k, v, valid = attn_inputs(0, B, Sq, Sk, H, K, Dh, p_valid)
    cnt = None if count is None else np.asarray(count, np.int32)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, kv_valid=jnp.asarray(valid),
        kv_count=None if cnt is None else jnp.asarray(cnt), interpret=True))
    got = flash_attention_ref(
        as_t(q), as_t(k), as_t(v), causal=causal, window=window,
        kv_valid=as_t(valid), kv_count=None if cnt is None else as_t(cnt)).numpy()
    live = _attendable(B, Sq, Sk, H, causal, window, valid, cnt)
    # rows with no attendable key are undefined in the Pallas kernel; the
    # port writes exact zeros there
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("window", [0, 24])
def test_decode_plain_matches_pallas(window):
    B, L, H, K, Dh = 4, 64, 8, 2, 32
    t = np.asarray([0, 5, 63, 150], np.int32)   # fresh, partial, full, wrapped
    k, v, pos, valid = ring(1, B, L, K, Dh, t)
    valid[0] = False                            # slot 0: no attendable key
    q = np.random.default_rng(2).standard_normal((B, 1, H, Dh),
                                                 dtype=np.float32)
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(t), window=window, kv_valid=jnp.asarray(valid),
        interpret=True))
    got = decode_attention_ref(as_t(q), as_t(k), as_t(v), as_t(pos), as_t(t),
                               window=window, kv_valid=as_t(valid)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()                     # exact zeros, as the kernel


@pytest.mark.parametrize("case", MLP_CASES)
def test_fused_mlp_plain_matches_pallas(case):
    shape, Fd, act, gated, weighted, count = case
    D = shape[-1]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape, dtype=np.float32)
    wi = rng.standard_normal((D, Fd), dtype=np.float32) * 0.05
    wo = rng.standard_normal((Fd, D), dtype=np.float32) * 0.05
    wg = rng.standard_normal((D, Fd), dtype=np.float32) * 0.05 if gated \
        else None
    tw = rng.random(shape[:-1]).astype(np.float32) if weighted else None
    cnt = None if count is None else np.asarray(count, np.int32)
    j = lambda a: None if a is None else jnp.asarray(a)
    want = np.asarray(jax_fused_mlp(j(x), j(wi), j(wo), j(wg), j(tw),
                                    act=act, valid_count=j(cnt),
                                    interpret=True))
    tt = lambda a: None if a is None else as_t(a)
    got = fused_mlp_ref(tt(x), tt(wi), tt(wo), tt(wg), tt(tw), act=act,
                        valid_count=tt(cnt)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain version and count nothing;
    backend='cuda' refuses CPU tensors instead of falling back."""
    ops.reset_launch_counts()
    q, k, v, valid = attn_inputs(4, 1, 32, 32, 2, 2, 32, 0.9)
    got = ops.flash_attention(as_t(q), as_t(k), as_t(v), as_t(valid))
    want = flash_attention_ref(as_t(q), as_t(k), as_t(v), kv_valid=as_t(valid))
    assert torch.equal(got, want)
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}
    with pytest.raises(ValueError):
        ops.flash_attention(as_t(q), as_t(k), as_t(v), backend="cuda")
    # int8 weights: fused_mlp and fused_mlp_routed (a train-mode serving
    # engine's admissions) take them (the plain versions on the CPU)
    x = as_t(q[0, :, 0])
    wi8, wo8 = torch.ones(32, 8, dtype=torch.int8), torch.ones(
        8, 32, dtype=torch.int8)
    wf = (torch.full((32, 8), 0.5), torch.full((8, 32), 0.25))
    sc = dict(wi_scale=torch.full((8,), 0.5),
              wo_scale=torch.full((32,), 0.25))
    got = ops.fused_mlp(x, wi8, wo8, act="gelu", **sc)
    want = fused_mlp_ref(x, *wf, act="gelu")
    assert torch.equal(got, want)
    idx = torch.tensor([[3, 0, 7, 1]])
    got = ops.fused_mlp_routed(x[None], idx, wi8, wo8, valid_count=3,
                               act="gelu", **sc)
    want = fused_mlp_routed_ref(x[None], idx, *wf, valid_count=3, act="gelu")
    assert torch.equal(got, want) and got[0, 3].abs().sum() > 0
    assert not got[0, 1].any()                  # past the count: zero
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}


# ------------------- the tensor-core MLP body's numerics ---------------------

BF16_TOL = dict(rtol=1e-2, atol=1e-2)   # chip_smoke.py's bf16 TOL


@pytest.mark.parametrize("act,gated", [("swiglu", True), ("gelu", False)])
def test_bf16_hidden_matches_pallas(act, gated):
    """The tensor-core body of csrc/fused_mlp.cu rounds the hidden H to
    bf16 between its phases (the wgmma A operand); the JAX kernel keeps it
    in f32. An emulation of that body (f32 products of bf16 inputs, H
    rounded to bf16, f32 down product, bf16 out) agrees with the JAX
    kernel, run in interpret mode on the same numpy-seeded bf16 inputs,
    within the bf16 tolerance the card holds the kernel to (rtol = atol =
    1e-2)."""
    import torch.nn.functional as F
    T, D, Fd = 64, 512, 2048
    rng = np.random.default_rng(21)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    x = bf(rng.standard_normal((T, D)))
    wi = bf(rng.standard_normal((D, Fd)) / D ** 0.5)
    wo = bf(rng.standard_normal((Fd, D)) / Fd ** 0.5)
    wg = bf(rng.standard_normal((D, Fd)) / D ** 0.5) if gated else None
    tw = jnp.asarray(rng.random(T), jnp.float32)
    want = np.asarray(jax_fused_mlp(x, wi, wo, wg, tw, act=act,
                                    interpret=True).astype(jnp.float32))
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
    h = tt(x) @ tt(wi)
    if gated:
        h = F.silu(tt(x) @ tt(wg)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    y = (h.to(torch.bfloat16).float() @ tt(wo)) * tt(tw)[:, None]
    got = y.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,F,wide", [(3584, 18944, True), (64, 256, True),
                                      (192, 320, True), (96, 256, False),
                                      (128, 160, False), (32, 128, False)])
def test_mlp_plan_picks_the_body(dtype, D, F, wide):
    """bf16 at widths that are multiples of 64 takes the tensor-core body;
    f32 (TF32 would break its 1e-4 tolerance) and other widths take the
    CUDA-core body. A tensor-core plan's tile rows and split depend on the
    shape only: 64-row tiles up to 64 rows, else 128; a split of the F
    reduction that fills MLP_FILL_BLOCKS blocks, never more parts than
    64-deep steps."""
    for B, T in ((1, 1), (1, 16), (1, 64), (1, 65), (2, 512), (4, 1024)):
        plan = ops.mlp_plan(dtype, B, T, D, F)
        assert plan == ops.mlp_plan(dtype, B, T, D, F)
        if dtype != torch.bfloat16 or not wide:
            assert plan.body == "cuda_core"
            continue
        assert plan.body == "wgmma"
        assert plan.rows == (64 if T <= 64 else 128)
        tiles = B * -(-T // plan.rows) * -(-D // 128)
        assert 1 <= plan.split <= F // 64
        assert plan.split == 1 or tiles * (plan.split - 1) < \
            ops.MLP_FILL_BLOCKS


# ------------- the Python around the decode and flash kernels ---------------

def test_decode_split_plan_for_the_ring():
    """Ring mode: splits of DECODE_CHUNK keys over [0, L)."""
    chunk = ops.DECODE_CHUNK
    for L, n in ((1, 1), (64, 1), (chunk - 1, 1), (chunk, 1), (chunk + 1, 2),
                 (1024, -(-1024 // chunk))):
        assert ops.decode_split_plan(L) == (chunk, n)


@pytest.mark.parametrize("ps", [1, 3, 8, 16, 48, 128, 256])
def test_decode_split_plan_is_whole_pages(ps):
    """Paged mode: a split is whole pages, at most one chunk unless a page
    is larger, and the splits cover the table row exactly once."""
    for P in (1, 7, 64):
        per, n = ops.decode_split_plan(P * ps, ps)
        assert per % ps == 0
        assert ps <= per <= max(ops.DECODE_CHUNK, ps)
        assert (n - 1) * per < P * ps <= n * per


class _Recorder:
    """Stands in for a kernel library: every ``*_launch`` records its
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' kernel path on CPU tensors, the launch recorded: only
    the Python before the launch runs (plan, scratch, shape checks,
    counts); the outputs are never read."""
    import contextlib
    lib = _Recorder()
    monkeypatch.setattr(ops, "use_kernel", lambda backend, t: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "load", lambda name: lib)
    monkeypatch.setattr(ops.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    scratch = []

    def record_scratch(*args, **kw):
        out = real_scratch(*args, **kw)
        scratch.append((tuple(out.shape), out.dtype))
        return out
    real_scratch = ops.decode_scratch
    monkeypatch.setattr(ops, "decode_scratch", record_scratch)
    lib.scratch = scratch
    return lib


def _decode_call(op, B, t, H=28, K=4, Dh=128, L=1024, ps=16):
    rng = np.random.default_rng(B)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, Dh),
                                             dtype=np.float32))
    tv = torch.full((B,), t, dtype=torch.int32)
    if op == "ring":
        kv = torch.zeros(B, L, K, Dh)
        pos = torch.arange(L, dtype=torch.int32).expand(B, L)
        return ops.decode_attention(q, kv, kv, pos, tv)
    P = L // ps
    pool = torch.zeros(B * P + 1, ps, K, Dh)
    table = torch.arange(B * P, dtype=torch.int32).reshape(B, P)
    return ops.paged_decode_attention(q, pool, pool, table, tv,
                                      torch.ones(B * P + 1, ps,
                                                 dtype=torch.bool))


@pytest.mark.parametrize("op", ["ring", "paged"])
def test_decode_wrappers_pass_a_fixed_split_plan(fake_launch, op):
    """The plan handed to the kernel depends on L (or P * ps) only: the
    same for B=1 and B=8 and any t; the f32 scratch holds (B, H, n_split,
    Dh) partial outputs and (B, H, n_split, 2) (max, sum) pairs; each call
    counts one launch (two CUDA launches on the card: the splits and their
    merge)."""
    name = "decode_attention" if op == "ring" else "paged_decode_attention"
    ops.reset_launch_counts()
    for B, t in ((1, 0), (8, 5), (1, 1023), (8, 700)):
        _decode_call(op, B, t)
    # (split keys, splits): after the dtype and storage codes, Dh, the
    # q, k, v, kscale, vscale, out, scratch and three mask pointers and five
    # ints
    plans = {(args[18], args[19]) for _, args in fake_launch.calls}
    split, n = ops.decode_split_plan(1024, 1 if op == "ring" else 16)
    assert plans == {(split, n)}
    assert [c for c, _ in fake_launch.calls] == [f"{name}_launch"] * 4
    for (B, _), shapes in zip(((1, 0), (8, 5), (1, 1023), (8, 700)),
                              fake_launch.scratch):
        assert shapes == ((B * 28 * n * (128 + 2),), torch.float32)
    assert ops.launch_counts()[name] == 4


@pytest.mark.parametrize("op", ["flash", "ring", "paged"])
def test_kernel_wrappers_refuse_unsupported_shapes(fake_launch, op):
    """On the kernel path each attention wrapper raises ValueError for a
    head width it has no instantiation for, or K not dividing H, before
    anything launches."""
    if op == "flash":
        run = lambda H, K, Dh: ops.flash_attention(
            torch.zeros(1, 8, H, Dh), torch.zeros(1, 8, K, Dh),
            torch.zeros(1, 8, K, Dh))
    else:
        run = lambda H, K, Dh: _decode_call(op, 2, 3, H=H, K=K, Dh=Dh, L=64)
    for H, K, Dh in ((4, 2, 48), (6, 4, 64), (4, 2, 8)):
        with pytest.raises(ValueError):
            run(H, K, Dh)
    if op != "flash":
        with pytest.raises(ValueError):    # 16 is a flash-only toy width
            run(4, 2, 16)
    assert fake_launch.calls == []
    run(4, 2, 64)
    assert len(fake_launch.calls) == 1


@pytest.mark.parametrize("routed", [False, True])
def test_mlp_wrappers_pass_the_plan(fake_launch, routed):
    """On the kernel path the MLP wrappers launch the body ``mlp_plan``
    picks: bf16 at widths that are multiples of 64 goes to
    fused_mlp_tc_launch with the plan's warpgroups (rows / 64) and split
    (and no f32 partials in dense mode with one part: the down phase
    stores the output), everything else to the CUDA-core entry; one count
    per call."""
    ops.reset_launch_counts()
    name = "fused_mlp_routed" if routed else "fused_mlp"
    for dt, D, Fd, T in ((torch.bfloat16, 128, 256, 16),
                         (torch.bfloat16, 128, 256, 300),
                         (torch.bfloat16, 256, 128, 3200),
                         (torch.float32, 128, 256, 16),
                         (torch.bfloat16, 96, 256, 16)):
        x = torch.zeros(2, T, D, dtype=dt)
        wi, wg = torch.zeros(D, Fd, dtype=dt), torch.zeros(D, Fd, dtype=dt)
        wo = torch.zeros(Fd, D, dtype=dt)
        if routed:
            idx = torch.arange(T // 2).expand(2, T // 2)
            ops.fused_mlp_routed(x, idx, wi, wo, wg)
            rows = T // 2
        else:
            ops.fused_mlp(x, wi, wo, wg)
            rows = T
        entry, args = fake_launch.calls[-1]
        plan = ops.mlp_plan(dt, 2, rows, D, Fd)
        if plan.body == "wgmma":     # after the weights' storage code
            assert entry == "fused_mlp_tc_launch"
            assert args[0] == 1            # bf16 weights: no scales
            assert args[6:9] == (None, None, None)
            assert args[14:17] == (2, rows, T) and args[20:22] == (
                plan.rows // 64, plan.split)
            assert (args[2] is not None) == routed
            assert (args[12] is None) == (plan.split == 1 and not routed)
        else:
            assert entry == f"{name}_launch"
    assert ops.launch_counts()[name] == 5
    assert ops.mlp_plan(torch.bfloat16, 2, 3200, 256, 128).split == 1


# ------------------- the grouped-expert MLP (moe_gmm) plan --------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,Fe,wide", [(3584, 2368, True), (2048, 1408, True),
                                       (128, 192, True), (64, 128, True),
                                       (64, 48, False), (96, 128, False),
                                       (32, 64, False)])
def test_gmm_plan_picks_the_body(dtype, D, Fe, wide):
    """moe_gmm's plan, mlp_plan over B * E groups of C slots (a function
    of the shape alone: the group counts never reach it): bf16 with D and
    Fe multiples of 64 takes the tensor-core body, f32 and other widths the
    CUDA-core body; one part of the down phase once its tiles fill the
    card."""
    for B, E, C in ((1, 8, 512), (2, 8, 256), (1, 60, 512), (1, 4, 44),
                    (2, 3, 130), (1, 1, 1)):
        plan = ops.mlp_plan(dtype, B * E, C, D, Fe)
        assert plan == ops.mlp_plan(dtype, B * E, C, D, Fe)
        assert plan.body == ("wgmma" if dtype == torch.bfloat16 and wide
                             else "cuda_core")
        if plan.body == "wgmma":
            assert plan.rows == (64 if C <= 64 else 128)
            assert 1 <= plan.split <= Fe // 64
            tiles = B * E * -(-C // plan.rows) * -(-D // 128)
            assert (plan.split == 1) == (tiles >= ops.MLP_FILL_BLOCKS)


def _gmm_weights(layout, E, D, Fe, dtype):
    """Expert weights in the two layouts the kernel reads in place: moefied
    views of dense (D, E*Fe) / (E*Fe, D) matrices, or native contiguous
    (E, D, Fe) / (E, Fe, D) stacks."""
    from repro_torch.core.moefy import moefy_mlp
    if layout == "moefied":
        ep = moefy_mlp({"wi": torch.zeros(D, E * Fe, dtype=dtype),
                        "wg": torch.zeros(D, E * Fe, dtype=dtype),
                        "wo": torch.zeros(E * Fe, D, dtype=dtype)}, E)
        return ep["wi"], ep["wg"], ep["wo"]
    return (torch.zeros(E, D, Fe, dtype=dtype),
            torch.zeros(E, D, Fe, dtype=dtype),
            torch.zeros(E, Fe, D, dtype=dtype))


@pytest.mark.parametrize("layout", ["moefied", "native"])
def test_moe_gmm_wrapper_passes_the_plan_and_maps(fake_launch, layout):
    """On the kernel path moe_gmm launches the body mlp_plan picks over its
    B * E groups: bf16 at
    widths that are multiples of 64 goes to moe_gmm_tc_launch with the
    plan's warpgroups and split and each matrix's 2-D map and expert step
    (moefied wi and wg: E*Fe columns, a step of Fe columns; native wi and
    wg: E*D rows, a step of D rows; wo in both: E*Fe rows, a step of Fe
    rows), read in place; f32 and other widths go to moe_gmm_launch with
    the strides. A layout that is neither form raises before any launch.
    One count per call."""
    ops.reset_launch_counts()
    B, E, C, D, Fe = 2, 3, 130, 128, 192
    for dt in (torch.bfloat16, torch.float32):
        wi, wg, wo = _gmm_weights(layout, E, D, Fe, dt)
        x = torch.zeros(B, E, C, D, dtype=dt)
        ops.moe_gmm(x, wi, wo, wg, None, torch.tensor([[130, 0, 1]] * B))
        entry, args = fake_launch.calls[-1]
        if dt == torch.float32:      # after the dtype and storage codes
            assert entry == "moe_gmm_launch"
            assert args[9:13] == (*wi.stride()[:2], *wo.stride()[:2])
            continue
        plan = ops.mlp_plan(dt, B * E, C, D, Fe)
        assert plan.body == "wgmma"
        assert entry == "moe_gmm_tc_launch"   # after the storage code
        assert args[2:5] == (wi.data_ptr(), wg.data_ptr(), wo.data_ptr())
        assert args[13:21] == (B, E, C, D, Fe, 0, plan.rows // 64,
                               plan.split)
        assert (args[11] is None) == (plan.split == 1)
        wi_map = ((E * Fe, D, Fe, 0) if layout == "moefied"
                  else (Fe, E * D, 0, D))
        assert args[21:29] == (*wi_map, D, E * Fe, 0, Fe)
    assert ops.launch_counts()["moe_gmm"] == 2
    # experts neither side by side nor stacked by whole rows, or a row
    # stride of 136 bytes (TMA takes multiples of 16): no tensor-core map;
    # the same strides run on the CUDA-core body in f32
    for es, rs, fe in ((D * Fe + 8, Fe, Fe), (D * 68, 68, 64)):
        for dt in (torch.bfloat16, torch.float32):
            store = torch.zeros(E * es + D * rs, dtype=dt)
            bad = store.as_strided((E, D, fe), (es, rs, 1))
            run = lambda: ops.moe_gmm(torch.zeros(1, E, 64, D, dtype=dt),
                                      bad, torch.zeros(E, fe, D, dtype=dt))
            n = len(fake_launch.calls)
            if dt == torch.float32:
                run()
                assert fake_launch.calls[-1][0] == "moe_gmm_launch"
                continue
            with pytest.raises(ValueError):
                run()
            assert len(fake_launch.calls) == n
            with pytest.raises(ValueError):
                ops.gmm_map(bad, (E, D, fe), "wi")
    assert ops.launch_counts()["moe_gmm"] == 4
