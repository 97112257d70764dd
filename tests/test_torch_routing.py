"""The port's train-mode routing against the JAX package's, on the CPU.

``make_plan`` must give the same idx/inv/valid/count/keep from the same
scores (exactly: integer and bool arrays), ties included, with one sort per
block; the capacity and bucket arithmetic must agree exactly; the plain
``fused_mlp_routed`` must match the JAX Pallas kernel in interpret mode and
its jnp oracle (f32, rtol=atol=1e-5: the same f32 products summed in another
order). The last tests check the autograd wrappers of ``kernels/ops.py``
with the plain version standing in for the kernel launch, in float64.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax.numpy as jnp  # noqa: E402

from repro.core import policy as JP  # noqa: E402
from repro.core import routing as JR  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref, fused_mlp_ref,  # noqa: E402
                                     fused_mlp_routed_ref)
from repro_torch.models import forward, model_init, router_init  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _scores(seed, B, S, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.random((B, S)).astype(np.float32)
    if ties:  # a few values repeated many times: ties straddle every k
        s = rng.choice(np.asarray([0.1, 0.5, 0.5, 0.9], np.float32), (B, S))
    return s


def _plans(scores, k_np, bucket):
    """The JAX and the port plan of the same scores and k."""
    jk = k_np if isinstance(k_np, int) else jnp.asarray(k_np)
    tk = k_np if isinstance(k_np, int) else torch.from_numpy(
        np.asarray(k_np, np.float32))
    return (JR.make_plan(jnp.asarray(scores), jk, bucket),
            R.make_plan(torch.from_numpy(scores), tk, bucket))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k,bucket", [
    (20, 32),                                  # static k
    (np.float32(13.0), 16),                    # () tensor k
    (np.asarray([5.0, 30.0], np.float32), 32),  # per-row (B,) k
    (40, 32),                                  # k clamped to the bucket
])
def test_make_plan_matches_jax(k, bucket, ties):
    scores = _scores(1, 2, 48, ties=ties)
    jp, tp = _plans(scores, k, bucket)
    for name in ("idx", "inv", "valid", "keep"):
        np.testing.assert_array_equal(
            np.asarray(getattr(tp, name)), np.asarray(getattr(jp, name)),
            err_msg=name)
    np.testing.assert_array_equal(np.asarray(tp.count),
                                  np.asarray(jp.count))
    assert tp.bucket == jp.bucket == bucket
    # the selected prefix ascends by position (causal order is kept)
    idx = tp.idx.numpy()
    for b in range(2):
        c = int(np.broadcast_to(np.asarray(tp.count), (2,))[b])
        assert (np.diff(idx[b, :c]) > 0).all()


def test_plan_gather_scatter_round_trip():
    scores = _scores(2, 3, 40)
    jp, tp = _plans(scores, np.asarray([7.0, 19.0, 24.0], np.float32), 24)
    x = np.random.default_rng(3).standard_normal((3, 40, 5)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    sel = R.plan_gather(tx, tp)
    np.testing.assert_array_equal(sel.numpy(),
                                  np.asarray(JR.plan_gather(jnp.asarray(x),
                                                            jp)))
    back = R.plan_scatter(tp, tx, sel)
    want = JR.plan_scatter(jp, jnp.asarray(x), JR.plan_gather(
        jnp.asarray(x), jp))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    # selected rows come back, every other row is zero
    keep = tp.keep.numpy()
    np.testing.assert_array_equal(back.numpy()[keep], x[keep])
    assert not back.numpy()[~keep].any()


@pytest.mark.parametrize("s", [1, 7, 24, 64, 100, 512, 1000, 1024, 1500,
                               4096])
def test_capacity_and_bucket_arithmetic_matches_jax(s):
    assert R.capacity_buckets(s) == JR.capacity_buckets(s)
    for cap in (0.01, 0.1, 0.25, 0.333, 0.5, 0.74, 0.9, 0.999, 1.0):
        for mxu in (False, True):
            k = R.capacity_k(cap, s, mxu=mxu)
            assert k == JR.capacity_k(cap, s, mxu=mxu)
            kt = R.capacity_k(torch.tensor(cap), s, mxu=mxu)
            kj = JR.capacity_k(jnp.float32(cap), s, mxu=mxu)
            assert float(kt) == float(kj)
        assert R.bucket_for(R.capacity_k(cap, s, mxu=True), s) == \
            JR.bucket_for(JR.capacity_k(cap, s, mxu=True), s)
        for static in (True, False):
            assert R.resolve_bucket(cap if static else torch.tensor(cap), s,
                                    bucket=16) == JR.resolve_bucket(
                cap if static else jnp.float32(cap), s, bucket=16)
        # ragged_bucket over per-row budgets, teacher rows and a spec
        for rows in ([cap, cap], [cap, 0.3], [1.0, 1.0]):
            tpol = TP.ElasticPolicy.stack(
                [TP.ElasticPolicy.uniform(r) for r in rows])
            jpol = JP.ElasticPolicy.stack(
                [JP.ElasticPolicy.uniform(r) for r in rows])
            spec_kw = dict(mlp_token_routed=True, mha_token_routed=False)
            assert TP.ragged_bucket(tpol, s) == JP.ragged_bucket(jpol, s)
            assert TP.ragged_bucket(
                tpol, s, spec=TP.ElasticSpec(**spec_kw)) == \
                JP.ragged_bucket(jpol, s, spec=JP.ElasticSpec(**spec_kw))
    teacher = TP.ElasticPolicy.uniform(0.3).replace(
        student=torch.tensor(0.0))
    assert TP.ragged_bucket(teacher, s) == R.IDENTITY_BUCKET


def test_capacity_anneal_and_solver_pieces_match_jax():
    for args in ((1.0, 0.5, 3), (0.9, 0.2, 10), (1.0, 0.5, 0)):
        t, j = TP.capacity_anneal(*args), JP.capacity_anneal(*args)
        assert [t(i) for i in range(12)] == [j(i) for i in range(12)]
    from repro.configs import get_config as jax_get_config
    for name in ("toy-lm", "qwen2-7b"):
        tcfg, jcfg = get_config(name), jax_get_config(name, "smoke")
        jcfg = dataclasses.replace(jcfg, **{
            f.name: getattr(tcfg, f.name)
            for f in dataclasses.fields(tcfg) if hasattr(jcfg, f.name)
            and f.name not in ("moe", "encoder")})
        spec_kw = dict(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
        ts, js = TP.ElasticSpec(**spec_kw), JP.ElasticSpec(**spec_kw)
        assert TP.stack_flops_per_token(tcfg, ts) == \
            JP.stack_flops_per_token(jcfg, js)
        for f in (0.1, 0.45, 0.8):
            assert TP._active_fraction(tcfg, ts, f, ctx=512) == \
                JP._active_fraction(jcfg, js, f, ctx=512)


def test_token_gate_train_and_bce_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 64)).astype(np.float32)
    for cap in (0.3, torch.tensor([0.3, 1.0])):
        jcap = cap if isinstance(cap, float) else jnp.asarray(cap.numpy())
        tl = torch.from_numpy(logits)
        keep, w = R.token_gate(tl, torch.sigmoid(tl), cap, "train", mxu=True)
        jk, jw = JR.token_gate(jnp.asarray(logits),
                               1 / (1 + jnp.exp(-jnp.asarray(logits))), jcap,
                               "train", mxu=True)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(
            float(R.bce_topk_loss(tl, keep)),
            float(JR.bce_topk_loss(jnp.asarray(logits), jk)), **TOL)
    # param_route_weights: the valid rows alone feed the load statistics
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 4)).astype(np.float32)
    valid = rng.random((2, 16)) < 0.6
    tw_, tm, ta = R.param_route_weights({"w": torch.from_numpy(w)},
                                        torch.from_numpy(x), 2,
                                        valid=torch.from_numpy(valid))
    jw_, jm, ja = JR.param_route_weights({"w": jnp.asarray(w)},
                                         jnp.asarray(x), 2,
                                         valid=jnp.asarray(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(ta.load), float(ja.load), **TOL)


def test_one_plan_sort_per_block():
    """The attention and MLP students share ONE RoutingPlan: one sort per
    block at a routed budget, none on the identity path or the teacher."""
    cfg = dataclasses.replace(get_config("toy-lm"), dtype="float32")
    spec = TP.ElasticSpec(mha_token_routed=True, mlp_token_routed=True)
    gen = torch.Generator().manual_seed(0)
    params = model_init(gen, cfg, spec, device="cpu")
    rp = router_init(gen, cfg, spec, device="cpu")
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32)}

    def sorts(budget, mode="train", static=True, bucket=None):
        pol = TP.ElasticPolicy.uniform(budget, static=static)
        before = R.PLAN_SORT_COUNT
        forward(params, rp, batch, cfg, spec, mode=mode, policy=pol,
                bucket=bucket)
        return R.PLAN_SORT_COUNT - before

    assert sorts(0.5) == cfg.n_layers
    assert sorts(0.5, static=False, bucket=32) == cfg.n_layers
    assert sorts(1.0) == 0
    assert sorts(1.0, static=False, bucket=R.IDENTITY_BUCKET) == 0
    assert sorts(1.0, mode="base") == 0


def _routed_inputs(seed, B, S, Kb, D, Fd, counts, gated=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    idx = np.stack([rng.permutation(S)[:Kb] for _ in range(B)]).astype(
        np.int32)
    w = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    wi, wo = w(D, Fd), w(Fd, D)
    wg = w(D, Fd) if gated else None
    tw = rng.random((B, Kb)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    return x, idx, wi, wo, wg, tw, cnt


@pytest.mark.parametrize("act,gated", [("swiglu", True), ("gelu", False)])
@pytest.mark.parametrize("counts", [[0, 5], [12, 16], [16, 16]])
def test_fused_mlp_routed_plain_matches_jax(counts, act, gated):
    x, idx, wi, wo, wg, tw, cnt = _routed_inputs(
        5, 2, 24, 16, 32, 64, counts, gated)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    jt = lambda a: None if a is None else jnp.asarray(a)
    got = fused_mlp_routed_ref(tt(x), tt(idx), tt(wi), tt(wo), tt(wg),
                               tt(tw), act=act, valid_count=tt(cnt))
    args = [jt(a) for a in (x, idx, wi, wo, wg, tw)]
    kern = jops.fused_mlp_routed(*args, valid_count=jt(cnt), act=act,
                                 backend="interpret")
    oracle = jref.fused_mlp_routed_ref(*args, act=act,
                                       valid_count=jt(cnt))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    # rows outside the live selection are exactly zero
    live = np.zeros((2, 24), bool)
    for b in range(2):
        live[b, idx[b, :cnt[b]]] = True
    assert not got.numpy()[~live].any()
    # the wrapper takes the plain version on CPU tensors and counts nothing
    ops.reset_launch_counts()
    np.testing.assert_array_equal(
        ops.fused_mlp_routed(tt(x), tt(idx), tt(wi), tt(wo), tt(wg), tt(tw),
                             tt(cnt), act=act).numpy(), got.numpy())
    assert ops.launch_counts()["fused_mlp_routed"] == 0


# --------------------- autograd wrappers of the kernels -----------------------

def _f64(rng, *shape, grad=True):
    return torch.tensor(rng.standard_normal(shape) * 0.5,
                        dtype=torch.float64, requires_grad=grad)


def _check_kernel_op(plain, args):
    """``KernelOp`` with the plain version standing in for the launch: its
    gradients pass gradcheck and equal plain autograd's, and the integer
    and bool inputs get None."""
    run = lambda *a: ops.KernelOp.apply(plain, plain, *a)
    assert torch.autograd.gradcheck(run, args, eps=1e-6, atol=1e-6)
    out = run(*args)
    g = torch.randn_like(out)
    diff = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    got = torch.autograd.grad(out, diff, g)
    want = torch.autograd.grad(plain(*args), diff, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    ctx_out = ops.KernelOp.apply(plain, plain, *args)
    grads = ctx_out.grad_fn.apply(torch.ones_like(ctx_out))
    for a, gi in zip(args, grads[2:]):
        if a is None or not a.is_floating_point():
            assert gi is None


def test_kernel_op_flash_attention_gradients():
    rng = np.random.default_rng(0)
    q, k, v = _f64(rng, 2, 6, 4, 8), _f64(rng, 2, 6, 2, 8), \
        _f64(rng, 2, 6, 2, 8)
    valid = torch.from_numpy(rng.random((2, 6)) < 0.7)
    valid[:, 0] = True
    cnt = torch.tensor([6, 4], dtype=torch.int32)
    plain = lambda q, k, v, m, c: flash_attention_ref(
        q, k, v, causal=True, kv_valid=m, kv_count=c)
    _check_kernel_op(plain, (q, k, v, valid, cnt))


def test_kernel_op_fused_mlp_gradients():
    rng = np.random.default_rng(1)
    x, tw = _f64(rng, 2, 5, 6), _f64(rng, 2, 5)
    wi, wo, wg = _f64(rng, 6, 10), _f64(rng, 10, 6), _f64(rng, 6, 10,
                                                          grad=False)
    cnt = torch.tensor([5, 3], dtype=torch.int32)
    plain = lambda x, wi, wo, wg, tw, c: fused_mlp_ref(
        x, wi, wo, wg, tw, act="swiglu", valid_count=c)
    _check_kernel_op(plain, (x, wi, wo, wg, tw, cnt))


def test_kernel_op_fused_mlp_routed_gradients():
    rng = np.random.default_rng(2)
    x, tw = _f64(rng, 2, 7, 6), _f64(rng, 2, 4)
    idx = torch.tensor([[6, 0, 3, 2], [1, 5, 4, 0]])
    wi, wo, wg = _f64(rng, 6, 10, grad=False), _f64(rng, 10, 6, grad=False), \
        _f64(rng, 6, 10, grad=False)
    cnt = torch.tensor([4, 2], dtype=torch.int32)
    plain = lambda x, i, wi, wo, wg, tw, c: fused_mlp_routed_ref(
        x, i, wi, wo, wg, tw, act="swiglu", valid_count=c)
    _check_kernel_op(plain, (x, idx, wi, wo, wg, tw, cnt))
