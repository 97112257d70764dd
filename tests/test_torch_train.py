"""The port's distillation training against the JAX package's, on the CPU at
toy-lm size in f32 (JAX on its jnp oracles, ``kernel_backend="ref"``; the
port on its kernels' plain versions, which CPU tensors take).

Tolerances (f32), each from summing the same f32 products in another
order: logits and the distillation objectives rtol=atol=1e-5; losses,
metrics and aux terms rtol=atol=1e-4; router gradients rtol=1e-3 plus
1e-4 of each leaf's largest gradient; router params and AdamW moments after
three steps rtol=1e-3, atol=2e-5. The routing decisions (top-k membership)
are held equal through ``sel_rate`` (1e-6) and the aux terms.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.core import distill as JD  # noqa: E402
from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import ragged_bucket as jax_ragged_bucket  # noqa: E402
from repro.data import LMDataPipeline as JaxPipeline  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.train_step import chunked_topk_kl as jax_chunked_kl  # noqa: E402
from repro.training.train_step import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch.core import distill as D  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.core.policy import (ElasticPolicy, ElasticSpec,  # noqa: E402
                                     ragged_bucket)
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.interop import (layered_to_numpy, train_state_from_numpy,  # noqa: E402
                                 train_state_to_numpy)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule  # noqa: E402
from repro_torch.optim.optimizer import tree_map  # noqa: E402
from repro_torch.training import (chunked_topk_kl, lm_loss,  # noqa: E402
                                  make_loss_fn, make_train_step)
from tests.test_torch_interop import toy_pair  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
S = 64                        # toy buckets at S=64: 16, 32, 48 (and 64)
N_HEADS = 4


@pytest.fixture(scope="module")
def setup():
    s = toy_pair(seed=0)
    s["jspec"] = dataclasses.replace(s["jspec"], kernel_backend="ref")
    pipe = LMDataPipeline(vocab=s["tcfg"].vocab_size, seq_len=S,
                          global_batch=2, seed=0)
    s["batches"] = [pipe.batch_at(i) for i in range(3)]
    return s


def _policies(budgets):
    """The same per-row budgets as a JAX and a port policy ((B,) leaves),
    and their ragged bucket (which both solvers must agree on)."""
    jp = JaxPolicy.stack([JaxPolicy.uniform(b, n_heads=N_HEADS)
                          for b in budgets])
    tp = ElasticPolicy.stack([ElasticPolicy.uniform(b, n_heads=N_HEADS)
                              for b in budgets])
    bucket = ragged_bucket(tp, S)
    assert bucket == jax_ragged_bucket(jp, S)
    return jp, tp, bucket


def _tokens(s, i=0):
    return s["batches"][i]


def _flat(tree, cfg, spec, name="routers"):
    return layered_to_numpy({}, cfg, spec, {name: tree})


@functools.lru_cache(maxsize=None)
def _jax_train_forward(jcfg, jspec):
    return jax.jit(lambda p, r, b, pol, bucket: jax_forward(
        p, r, b, jcfg, jspec, mode="train", policy=pol, bucket=bucket),
        static_argnames=("bucket",))


@pytest.mark.parametrize("budgets", [
    [1.0, 1.0], [0.75, 0.75], [0.5, 0.5], [0.25, 0.25],
    [0.5, 0.25],          # per-row budgets: per-row top-k in one plan
    [0.9, 0.9],           # the covering bucket is S: the dense path
], ids=lambda b: "-".join(map(str, b)))
def test_train_forward_matches_jax(setup, budgets):
    s = setup
    jp, tp, bucket = _policies(budgets)
    tok = _tokens(s)
    jl, ja = _jax_train_forward(s["jcfg"], s["jspec"])(
        s["params"], s["rp"], {"tokens": jnp.asarray(tok)}, jp,
        bucket=bucket)
    tl, ta = forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(tok)},
                     s["tcfg"], s["tspec"], mode="train", policy=tp,
                     bucket=bucket)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("load", "topk", "sel", "cnt"):
        np.testing.assert_allclose(float(getattr(ta, name)),
                                   float(getattr(ja, name)), **TOL,
                                   err_msg=name)
    assert float(ta.sel_rate) == pytest.approx(float(ja.sel_rate), abs=1e-6)
    if budgets[0] == 1.0:
        assert bucket == R.IDENTITY_BUCKET
        base, _ = forward(s["tparams"], s["trp"],
                          {"tokens": torch.from_numpy(tok)}, s["tcfg"],
                          s["tspec"], mode="base")
        assert torch.equal(tl, base)          # budget 1.0 == the teacher


def _jax_loss_and_grads(s, jp, bucket, remat):
    lf = jax_make_loss_fn(s["jcfg"], s["jspec"], remat=remat)
    vg = jax.jit(jax.value_and_grad(lf, has_aux=True),
                 static_argnames=("bucket",))
    (loss, m), g = vg(s["rp"], s["params"],
                      {"tokens": jnp.asarray(_tokens(s))}, jp, bucket=bucket)
    return loss, m, _flatten({"routers": g})


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("budget", [1.0, 0.5])
def test_loss_and_router_grads_match_jax(setup, budget, remat):
    s = setup
    jp, tp, bucket = _policies([budget, budget])
    jloss, jm, jg = _jax_loss_and_grads(s, jp, bucket, remat)
    lf = make_loss_fn(s["tcfg"], s["tspec"], remat=remat)
    rp = tree_map(lambda t: t.clone().requires_grad_(True), s["trp"])
    loss, m = lf(rp, s["tparams"], {"tokens": torch.from_numpy(_tokens(s))},
                 tp, bucket)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for k in ("distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    if budget == 1.0:
        assert float(m["distill"]) == 0.0     # the student is the teacher
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, rp)
    got = _flat(grads, s["tcfg"], s["tspec"])
    assert sorted(got) == sorted(jg)
    for key, want in jg.items():
        scale = max(1e-3, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)


def test_three_train_steps_match_jax(setup):
    """Both trainers start from the same state (the JAX AdamWState carried
    over by interop) and anneal the budget 0.75 -> 0.5 -> 0.25. The anneal
    does not start at 1.0 here: there the head router's gradient is 0 in
    exact arithmetic (every head is kept, so its load term is constant),
    and AdamW's first step, ~lr * sign(g), turns both frameworks' f32
    noise (~1e-8) into updates of +-lr. The identity step is held to JAX
    by the loss-and-gradient test above."""
    s = setup
    jstate = jax_init_state(s["rp"])
    flat = _flatten({"router": jstate.router_params, "opt_m": jstate.opt.m,
                     "opt_v": jstate.opt.v})
    tstate = train_state_from_numpy(flat, int(jstate.opt.step), s["tcfg"],
                                    s["tspec"], device="cpu")
    jstep = jax.jit(jax_make_train_step(
        s["jcfg"], s["jspec"], lr=jax_cosine(1e-3, 3), remat=True),
        static_argnames=("bucket",))
    tstep = make_train_step(s["tcfg"], s["tspec"], lr=cosine_schedule(1e-3, 3),
                            remat=True)
    for i, b in enumerate([0.75, 0.5, 0.25]):
        jp, tp, bucket = _policies([b, b])
        tok = _tokens(s, i)
        jstate, jm = jstep(jstate, s["params"], {"tokens": jnp.asarray(tok)},
                           jp, bucket=bucket)
        tstate, tm = tstep(tstate, s["tparams"],
                           {"tokens": torch.from_numpy(tok)}, tp, bucket)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    got, step = train_state_to_numpy(tstate, s["tcfg"], s["tspec"])
    assert step == int(jstate.opt.step) == 3
    want = _flatten({"router": jstate.router_params, "opt_m": jstate.opt.m,
                     "opt_v": jstate.opt.v})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=2e-5,
                                   err_msg=key)


def test_train_state_interop_round_trip(setup):
    s = setup
    rng = np.random.default_rng(1)
    jstate = jax_init_state(s["rp"])
    flat = {k: rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in _flatten({"router": jstate.router_params,
                                  "opt_m": jstate.opt.m,
                                  "opt_v": jstate.opt.v}).items()}
    state = train_state_from_numpy(flat, 7, s["tcfg"], s["tspec"],
                                   device="cpu")
    back, step = train_state_to_numpy(state, s["tcfg"], s["tspec"])
    assert step == 7 and state.opt.step.dtype == torch.int32
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_distill_objectives_match_jax():
    rng = np.random.default_rng(2)
    s_np = rng.standard_normal((2, 6, 300)).astype(np.float32) * 2
    t_np = rng.standard_normal((2, 6, 300)).astype(np.float32) * 2
    ts, tt = torch.from_numpy(s_np), torch.from_numpy(t_np)
    js, jt = jnp.asarray(s_np), jnp.asarray(t_np)
    for temp in (1.0, 2.0):
        for d in ("fwd", "rev"):
            np.testing.assert_allclose(
                float(D.kl_divergence(ts, tt, temp, d)),
                float(JD.kl_divergence(js, jt, temp, d)), **LOGIT_TOL)
            np.testing.assert_allclose(
                float(D.topk_kl(ts, tt, k=50, temp=temp, direction=d)),
                float(JD.topk_kl(js, jt, k=50, temp=temp, direction=d)),
                **LOGIT_TOL)
    np.testing.assert_allclose(float(D.cosine_distance(ts, tt)),
                               float(JD.cosine_distance(js, jt)),
                               **LOGIT_TOL)
    tok = rng.integers(0, 300, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(float(lm_loss(ts, torch.from_numpy(tok))),
                               float(jax_lm_loss(js, jnp.asarray(tok))),
                               **LOGIT_TOL)
    for kind in ("topk_kl", "topk_kl_rev", "fwd_kl", "rev_kl", "cosine"):
        spec = ElasticSpec(distill_loss=kind)    # both read its fields
        np.testing.assert_allclose(
            float(D.distill_loss(ts, tt, spec)),
            float(JD.distill_loss(js, jt, spec)), **LOGIT_TOL, err_msg=kind)
    # the residual bucket's clip: a top-k that holds all the mass
    one = torch.full((1, 3), -1.0986123)
    assert float(D.topk_kl_from_gathered(one, one)) == 0.0


@pytest.mark.parametrize("full", [False, True])
def test_chunked_topk_kl_matches_unchunked_and_jax(full):
    rng = np.random.default_rng(3)
    hs = rng.standard_normal((2, 32, 16)).astype(np.float32)
    ht = rng.standard_normal((2, 32, 16)).astype(np.float32)
    head = rng.standard_normal((16, 256)).astype(np.float32)
    kw = dict(k=20, vocab=250, direction="fwd", temp=1.5, full=full)
    args = [torch.from_numpy(a) for a in (hs, ht, head)]
    whole = chunked_topk_kl(*args, seq_chunk=32, **kw)
    for c in (8, 12):          # 12 does not divide 32: 8-token chunks
        np.testing.assert_allclose(float(chunked_topk_kl(
            *args, seq_chunk=c, **kw)), float(whole), **LOGIT_TOL)
    want = jax_chunked_kl(*[jnp.asarray(a) for a in (hs, ht, head)],
                          mesh=None, seq_chunk=8, **kw)
    np.testing.assert_allclose(float(whole), float(want), **LOGIT_TOL)
    # gradients reach the student through the recomputed chunks
    h = args[0].clone().requires_grad_(True)
    chunked_topk_kl(h, args[1], args[2], seq_chunk=8, **kw).backward()
    assert torch.isfinite(h.grad).all() and h.grad.abs().sum() > 0


def test_adamw_and_cosine_schedule_match_jax():
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (5, 3), "b": ()}, "l": [(4,), (2, 2)]}
    mk = lambda: {"a": {k: rng.standard_normal(v).astype(np.float32)
                        for k, v in shapes["a"].items()},
                  "l": [rng.standard_normal(v).astype(np.float32)
                        for v in shapes["l"]]}
    p_np, grads_np = mk(), [mk() for _ in range(3)]
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)
    tp, jpar = to_t(p_np), jax.tree.map(jnp.asarray, p_np)
    tstate, jstate = adamw_init(tp), jax_adamw_init(jpar)
    tsched, jsched = cosine_schedule(1e-2, 50), jax_cosine(1e-2, 50)
    for step in (0, 1, 2, 10, 25, 49, 50, 60):
        np.testing.assert_allclose(float(tsched(step)), float(jsched(step)),
                                   rtol=1e-6, atol=1e-9)
    for g in grads_np:
        tp, tstate, tm = adamw_update(to_t(g), tstate, tp, lr=tsched,
                                      weight_decay=0.1, max_grad_norm=0.5)
        jpar, jstate, jm = jax_adamw_update(
            jax.tree.map(jnp.asarray, g), jstate, jpar, lr=jsched,
            weight_decay=0.1, max_grad_norm=0.5)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    for got, want in ((tp, jpar), (tstate.m, jstate.m),
                      (tstate.v, jstate.v)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7), got, want)


def test_data_pipeline_matches_jax():
    for kw in (dict(vocab=2048, seq_len=24, global_batch=4, seed=0),
               dict(vocab=500, seq_len=16, global_batch=6, n_shards=3,
                    shard=1, seed=5, chain_seed=2)):
        t, j = LMDataPipeline(**kw), JaxPipeline(**kw)
        for step in (0, 1, 7):
            np.testing.assert_array_equal(t.batch_at(step), j.batch_at(step))
        next(t)
        assert t.state() == {"step": 1, "seed": kw["seed"],
                             "shard": kw.get("shard", 0)}


def test_trainer_cli_path_on_the_cpu():
    """``launch.train`` on toy-lm: the full-budget first step takes the
    identity path (distill exactly 0), the annealed ones a ragged bucket;
    without ``device`` it asks for the CUDA card."""
    state, hist, _, _ = train("toy-lm", total_steps=3, seq_len=S,
                              global_batch=2, budget=0.5, anneal_from=1.0,
                              anneal_steps=2, device="cpu")
    assert hist[0]["bucket"] == R.IDENTITY_BUCKET
    assert all(0 < h["bucket"] < S for h in hist[1:])
    assert hist[0]["distill"] == 0.0
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert int(state.opt.step) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train("toy-lm", total_steps=1, seq_len=16, global_batch=2)
