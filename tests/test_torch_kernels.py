"""The port's kernels: each plain PyTorch version against the JAX Pallas
kernel run in interpret mode (as tests/test_kernels.py runs it). The CUDA
kernels against these plain versions are in tests/test_torch_cuda.py.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
Tolerance: f32 rtol=atol=1e-5 (the same f32 math summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp as jax_fused_mlp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     flash_attention_ref, fused_mlp_ref)
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
    with pytest.raises(NotImplementedError):
        ops.fused_mlp(as_t(q[0, :, 0]), torch.ones(32, 8), torch.ones(8, 32),
                      wi_scale=torch.ones(8))
