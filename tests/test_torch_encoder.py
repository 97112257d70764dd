"""The encoder families against the JAX package, on the CPU in f32: the ViT
encoder (``toy-vit``: a bidirectional stack over patch embeddings,
distilled by the cosine distance of its output embeddings) and the
encoder-decoder (Whisper-medium-smoke: the nested encoder runs
non-causally over the frames, its output is selected by the ``vlm``
router and cross-attended by every decoder layer). Forward in base /
infer / train (the plan path of a non-causal stack included), prefill
caches and decode steps, a distillation step's loss and router gradients
(the encoder routers' under ``encoder``), two train steps, the ring
engine with ``frames`` as ``extra_inputs``; and within the port: budget
1.0 == the teacher bit for bit, staggered == solo, ``procedural_images``
bit for bit, the interop and checkpoint round trips of the nested trees,
the paged layout's refusal.

Tolerances and margins as in tests/test_torch_vlm.py, whose set-up this
file shares.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.core.policy import ragged_bucket as jax_ragged_bucket  # noqa: E402
from repro.data.pipeline import procedural_images as jax_images  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, get_elastic  # noqa: E402
from repro_torch.core.policy import ragged_bucket, spec_from_config  # noqa: E402
from repro_torch.data import procedural_images  # noqa: E402
from repro_torch.interop import (layered_to_numpy, params_to_numpy,  # noqa: E402
                                 train_state_from_numpy, train_state_from_tree,
                                 train_state_to_numpy, train_state_tree)
from repro_torch.models import (decode_step, forward, model_init,  # noqa: E402
                                prefill, router_init)
from repro_torch.optim.optimizer import tree_map  # noqa: E402
from repro_torch.training import (GenRequest, ServingEngine,  # noqa: E402
                                  make_loss_fn, make_train_step)
from tests.test_torch_interop import RouterMargins  # noqa: E402
from tests.test_torch_vlm import (LOSS_TOL, SPECS, TOL, ContextMargins,  # noqa: E402
                                  _pair, as_jax, as_torch, context_inputs,
                                  policies)

VIT, WHISPER = "toy-vit", "whisper-medium"


@pytest.mark.parametrize("n,patches,dim,seed,class_id", [
    (4, 64, 128, 0, None), (3, 16, 32, 7, 3), (2, 1601, 8, 1, None)])
def test_procedural_images_match_jax_bit_for_bit(n, patches, dim, seed,
                                                 class_id):
    got = procedural_images(n, patches, dim, seed, class_id=class_id)
    want = jax_images(n, patches, dim, seed, class_id=class_id)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _vit_batch(cfg, B=2, seed=0):
    emb, _ = procedural_images(B, cfg.n_image_tokens, cfg.d_frontend, seed)
    return {"embeds": emb}


def _bucket(jp, tp, S):
    bucket = ragged_bucket(tp, S)
    assert bucket == jax_ragged_bucket(jp, S)
    return bucket


@pytest.mark.parametrize("which", SPECS)
@pytest.mark.parametrize("mode,budget,static,bucketed", [
    ("base", 1.0, False, False), ("infer", 1.0, False, False),
    ("infer", 0.5, False, False), ("train", 0.5, False, False),
    ("train", 0.5, False, True), ("train", 0.5, True, False),
    ("train", 1.0, False, True)],
    ids=["base", "infer-1.0", "infer-0.5", "train-0.5-dense",
         "train-0.5-plan", "train-0.5-static", "train-1.0-identity"])
def test_vit_forward_matches_jax(which, mode, budget, static, bucketed,
                                 monkeypatch):
    """The non-causal stack's output embeddings; ``bucketed``: a tensor
    policy with its ragged bucket (the plan path: the selected tokens
    attend to each other both ways, by array index)."""
    s = _pair(VIT, which)
    cfg = s["tcfg"]
    batch = _vit_batch(cfg)
    jp, tp = policies([budget], cfg, static, s["tspec"])
    bucket = _bucket(jp, tp, cfg.n_image_tokens) if bucketed else None
    margins = RouterMargins(monkeypatch)
    got, aux = forward(s["tparams"], s["trp"], as_torch(batch), cfg,
                       s["tspec"], mode=mode, policy=tp, bucket=bucket)
    want, jaux = jax_forward(s["params"], s["rp"], as_jax(batch), s["jcfg"],
                             s["jspec"], mode=mode, policy=jp, bucket=bucket)
    assert got.shape == (2, cfg.n_image_tokens, cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.sel_rate), float(jaux.sel_rate),
                               **LOSS_TOL)
    if mode == "infer":
        margins.check()
    if budget == 1.0 and which == "slice":
        base, _ = forward(s["tparams"], s["trp"], as_torch(batch), cfg,
                          s["tspec"], mode="base")
        assert torch.equal(got, base)


def _grads_match(got_tree, cfg, spec, jg):
    got = layered_to_numpy({}, cfg, spec, {"routers": got_tree})
    assert sorted(got) == sorted(jg)
    for key, want in jg.items():
        scale = max(1e-3, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)
    return got


def _loss_and_grads(s, batch, jp, tp, bucket=None):
    lf = jax_make_loss_fn(s["jcfg"], s["jspec"])
    (jloss, jm), g = jax.value_and_grad(lf, has_aux=True)(
        s["rp"], s["params"], as_jax(batch), jp, bucket)
    rp = tree_map(lambda t: t.clone().requires_grad_(True), s["trp"])
    loss, m = make_loss_fn(s["tcfg"], s["tspec"])(
        rp, s["tparams"], as_torch(batch), tp, bucket)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    for k in ("distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), **LOSS_TOL,
                                   err_msg=k)
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, rp)
    return m, _grads_match(grads, s["tcfg"], s["tspec"],
                           _flatten({"routers": g}))


@pytest.mark.parametrize("which", SPECS)
@pytest.mark.parametrize("kind", ["static", "tensor", "plan"])
def test_vit_cosine_loss_and_grads_match_jax(which, kind):
    """The encoder branch of the loss: 1 - cos(student, teacher) of the
    output embeddings, at budget 0.6, static, tensor (dense) or tensor
    with its bucket (plan)."""
    s = _pair(VIT, which)
    cfg = s["tcfg"]
    batch = _vit_batch(cfg, seed=1)
    jp, tp = policies([0.6], cfg, kind == "static", s["tspec"])
    bucket = _bucket(jp, tp, cfg.n_image_tokens) if kind == "plan" else None
    m, got = _loss_and_grads(s, batch, jp, tp, bucket)
    assert float(m["distill"].detach()) > 0
    assert np.abs(got["['routers']['scan'][0]['tok_mixer']['w']"]).max() > 0


def test_vit_train_steps_match_jax():
    """Two train steps (anneal 0.75 -> 0.5) from the same state, in both
    packages: metrics, routers and AdamW moments."""
    s = _pair(VIT, "slice")
    cfg = s["tcfg"]
    jstate = jax_init_state(s["rp"])
    flat = _flatten({"router": jstate.router_params, "opt_m": jstate.opt.m,
                     "opt_v": jstate.opt.v})
    tstate = train_state_from_numpy(flat, int(jstate.opt.step), cfg,
                                    s["tspec"], device="cpu")
    jstep = jax.jit(jax_make_train_step(s["jcfg"], s["jspec"], lr=1e-3),
                    static_argnames=("bucket",))
    tstep = make_train_step(cfg, s["tspec"], lr=1e-3)
    for i, b in enumerate([0.75, 0.5]):
        jp, tp = policies([b], cfg, spec=s["tspec"])
        bucket = _bucket(jp, tp, cfg.n_image_tokens)
        batch = _vit_batch(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, s["params"], as_jax(batch), jp,
                           bucket=bucket)
        tstate, tm = tstep(tstate, s["tparams"], as_torch(batch), tp, bucket)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    got, step = train_state_to_numpy(tstate, cfg, s["tspec"])
    want = _flatten({"router": jstate.router_params, "opt_m": jstate.opt.m,
                     "opt_v": jstate.opt.v})
    assert step == 2 and sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=2e-5,
                                   err_msg=key)


def _whisper_batch(cfg, B=2, S=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), **context_inputs(cfg, B, seed + 1)}


@pytest.mark.parametrize("which", SPECS)
@pytest.mark.parametrize("mode,budget,static", [
    ("base", 1.0, False), ("infer", 1.0, False), ("infer", 0.5, False),
    ("infer", 0.5, True), ("train", 0.5, False), ("train", 0.5, True)],
    ids=["base", "infer-1.0", "infer-0.5", "infer-0.5-static", "train-0.5",
         "train-0.5-static"])
def test_whisper_forward_matches_jax(which, mode, budget, static,
                                     monkeypatch):
    s = _pair(WHISPER, which)
    cfg = s["tcfg"]
    batch = _whisper_batch(cfg)
    jp, tp = policies([budget], cfg, static, s["tspec"])
    margins, cm = RouterMargins(monkeypatch), ContextMargins(monkeypatch)
    got, aux = forward(s["tparams"], s["trp"], as_torch(batch), cfg,
                       s["tspec"], mode=mode, policy=tp)
    want, jaux = jax_forward(s["params"], s["rp"], as_jax(batch), s["jcfg"],
                             s["jspec"], mode=mode, policy=jp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.sel_rate), float(jaux.sel_rate),
                               **LOSS_TOL)
    if mode == "infer":
        margins.check()
    if mode != "base" and budget < 1.0:
        cm.check()


def test_whisper_prefill_caches_and_decode_match_jax(monkeypatch):
    s = _pair(WHISPER, "registered")
    cfg = s["tcfg"]
    batch = _whisper_batch(cfg, seed=8)
    jp, tp = policies([0.5, 1.0], cfg, spec=s["tspec"])
    margins, cm = RouterMargins(monkeypatch), ContextMargins(monkeypatch)
    L = 20
    jl, jc = jax_prefill(s["params"], s["rp"], as_jax(batch), s["jcfg"],
                         s["jspec"], mode="infer", max_cache_len=L, policy=jp)
    tl, tc = prefill(s["tparams"], s["trp"], as_torch(batch), cfg,
                     s["tspec"], mode="infer", max_cache_len=L, policy=tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    t = np.asarray([10, 10], np.int32)
    rng = np.random.default_rng(4)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jax_decode_step(s["params"], s["rp"], jnp.asarray(nxt), jc,
                                 jnp.asarray(t), s["jcfg"], s["jspec"],
                                 mode="infer", policy=jp)
        tl, tc = decode_step(s["tparams"], s["trp"], torch.from_numpy(nxt),
                             tc, torch.from_numpy(t), cfg, s["tspec"],
                             mode="infer", policy=tp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        t = t + 1
    want = _flatten(jc)
    got = {k[len("['c']"):]: v for k, v in layered_to_numpy(
        {}, cfg, None, {"c": tc}).items()}
    assert sorted(got) == sorted(want)
    assert any("['xattn']['k']" in k for k in want)
    for k, w in want.items():
        if w.dtype == bool or w.dtype.kind == "i":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)
    margins.check()
    cm.check()


@pytest.mark.parametrize("static", [True, False], ids=["static", "tensor"])
def test_whisper_loss_and_router_grads_match_jax(static):
    """The decoder's top-k KL with the encoder in the graph: the encoder
    routers (under ``encoder``, fed by the decoder's policy) and the
    frame-token router get their gradients."""
    s = _pair(WHISPER, "registered")
    cfg = s["tcfg"]
    jp, tp = policies([0.6], cfg, static, s["tspec"])
    _, got = _loss_and_grads(s, _whisper_batch(cfg, S=16, seed=5), jp, tp)
    assert np.abs(got["['routers']['vlm']['w']"]).max() > 0
    assert np.abs(got["['routers']['encoder']['scan'][0]['tok_mlp']['w']"]
                  ).max() > 0


BATCH, MAX_SEQ, PLEN, NEW = 3, 32, 6, 6
BUDGETS = [1.0, 0.5, None, 0.75]


def _frames(cfg, n, seed):
    f = context_inputs(cfg, n, seed)["frames"]
    return [f[i:i + 1] for i in range(n)]


def _staggered(engine, make_req, prompts, budgets, frames):
    handles = [engine.submit(make_req(p, NEW, budget=b),
                             extra_inputs={"frames": f})
               for p, b, f in zip(prompts[:2], budgets[:2], frames[:2])]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(make_req(p, NEW, budget=b),
                              extra_inputs={"frames": f})
                for p, b, f in zip(prompts[2:], budgets[2:], frames[2:])]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return [list(h.output) for h in handles]


def _workload(cfg, seed=6):
    rng = np.random.default_rng(seed)
    prompts = list(rng.integers(0, cfg.vocab_size, (len(BUDGETS), PLEN))
                   .astype(np.int32))
    return prompts, _frames(cfg, len(BUDGETS), seed + 1)


def _engine(s, mode="infer", **kw):
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu", **kw)


@pytest.mark.parametrize("which", SPECS)
def test_whisper_engine_tokens_match_jax(which, monkeypatch):
    s = _pair(WHISPER, which)
    prompts, frames = _workload(s["tcfg"])
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ)
    want = _staggered(jeng, JaxRequest, prompts, BUDGETS, frames)
    margins, cm = RouterMargins(monkeypatch), ContextMargins(monkeypatch)
    got = _staggered(_engine(s), GenRequest, prompts, BUDGETS, frames)
    margins.check()
    cm.check()
    assert got == want


def test_whisper_engine_budget_one_and_staggered_equals_solo():
    s = _pair(WHISPER, "slice")
    prompts, frames = _workload(s["tcfg"])
    got = _staggered(_engine(s), GenRequest, prompts, BUDGETS, frames)
    base = _staggered(_engine(s, mode="base"), GenRequest, prompts, BUDGETS,
                      frames)
    full = [i for i, b in enumerate(BUDGETS) if b in (1.0, None)]
    assert [got[i] for i in full] == [base[i] for i in full]
    for i in (1, 3):
        solo = _engine(s).generate(
            [GenRequest(prompts[i], NEW, budget=BUDGETS[i])],
            extra_inputs={"frames": frames[i]})
        assert list(solo[0]) == got[i]


@pytest.mark.parametrize("extra", [
    None, {"image_embeds": 0}, {"frames": (0, -1, 0)},
    {"frames": (0, 0, 1)}], ids=["none", "wrong-key", "short", "wide"])
def test_whisper_submit_refuses_bad_extra_inputs(extra):
    """An encoder-decoder request needs exactly one (1, encoder_seq,
    d_model) ``frames`` row; anything else is refused at submit, before it
    is queued."""
    s = _pair(WHISPER, "slice")
    cfg = s["tcfg"]
    prompts, frames = _workload(cfg)
    if extra:
        extra = {k: np.zeros(tuple(g + d for g, d in zip(
            frames[0].shape, v)), np.float32) if isinstance(v, tuple)
            else frames[0] for k, v in extra.items()}
    eng = _engine(s)
    with pytest.raises(ValueError, match="frames"):
        eng.submit(GenRequest(prompts[0], NEW), extra_inputs=extra)
    assert not eng.has_work and eng._extras == {}


def test_decoder_only_engine_refuses_extra_inputs():
    """A decoder-only model takes no context: ``extra_inputs`` are refused
    at submit."""
    cfg = get_config("toy-lm")
    spec = spec_from_config(get_elastic("toy-lm", cfg))
    gen = torch.Generator().manual_seed(0)
    eng = ServingEngine(model_init(gen, cfg, spec, device="cpu"),
                        router_init(gen, cfg, spec, device="cpu"), cfg, spec,
                        batch_size=1, max_seq=MAX_SEQ, device="cpu")
    prompt = np.arange(PLEN, dtype=np.int32)
    with pytest.raises(ValueError, match="takes no extra_inputs"):
        eng.submit(GenRequest(prompt, NEW),
                   extra_inputs={"image_embeds": np.zeros((1, 4, 4))})
    assert not eng.has_work
    eng.submit(GenRequest(prompt, NEW), extra_inputs={})


@pytest.mark.parametrize("arch", [VIT, WHISPER])
def test_nested_trees_round_trip(arch, tmp_path):
    """Params and routers (an encoder-decoder's nested ``encoder`` trees
    with their own scan/tail split) from JAX and back bit for bit, and a
    train state of them through the port's Checkpointer."""
    s = _pair(arch, "registered")
    cfg, spec = s["tcfg"], s["tspec"]
    back = params_to_numpy(s["tparams"], s["trp"], cfg, spec)
    assert sorted(back) == sorted(s["flat"])
    for k, v in s["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if arch == WHISPER:
        assert len(s["tparams"]["encoder"]["layers"]) == cfg.encoder.n_layers
        assert "['routers']['encoder']['scan'][0]['tok_mixer']['w']" in back
    else:
        assert "embed" not in s["tparams"] and "in_proj" in s["tparams"]
    from repro_torch.training import init_train_state
    state = init_train_state(s["trp"])
    ck = Checkpointer(str(tmp_path))
    ck.save(1, train_state_tree(state, cfg, spec), extra={"opt_step": 0},
            blocking=True)
    loaded, extra = ck.restore(1, tree_map(torch.zeros_like,
                                           train_state_tree(state, cfg, spec)))
    got = train_state_from_tree(loaded, extra["opt_step"], cfg, spec)
    want = layered_to_numpy({}, cfg, spec, {"r": s["trp"]})
    have = layered_to_numpy({}, cfg, spec, {"r": got.router_params})
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_paged_layout_refuses_the_encoder_decoder():
    s = _pair(WHISPER, "slice")
    with pytest.raises(ValueError, match="decoder-only"):
        _engine(s, kv_layout="paged", page_size=8)


def test_configs_and_param_counts():
    """The registered context configs: layer kinds, the nested encoder and
    the parameter count (the JAX package's, plus the ``in_proj``
    frontend projection(s) it leaves out)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for name in (VIT, "toy-vlm", "llama-3.2-vision-11b", WHISPER):
        for variant in ("smoke", "full"):
            t, j = get_config(name, variant), jax_get_config(name, variant)
            assert t.layer_kinds == j.layer_kinds
            frontends = [c for c in (t, t.encoder) if c is not None and (
                c.family in ("encoder", "vlm") or c.d_frontend)]
            extra = sum((c.d_frontend or c.d_model) * c.d_model
                        for c in frontends)
            assert t.n_params() == j.n_params() + extra, (name, variant)
    full = get_config("llama-3.2-vision-11b")
    assert full.layer_kinds.count("xattn") == 8
    assert (full.n_image_tokens, full.d_frontend) == (1601, 1280)
    w = get_config(WHISPER)
    assert w.encoder.n_layers == 24 and w.encoder_seq == 1500
    assert dataclasses.replace(w, n_layers=2).layer_kinds == ("xattn",) * 2
