"""The VLM family (``xattn`` layers over projected image embeddings, the
``vlm`` image-token router) against the JAX package, on the CPU in f32, at
toy-vlm and Llama-3.2-Vision-smoke size: forward in base / infer / train,
``select_context_tokens`` static and tensor, prefill caches (the context
caches too) and decode steps, a distillation step's loss and router
gradients, the ring engine with ``extra_inputs``; and within the port:
budget 1.0 == the teacher bit for bit, staggered == solo, the image
deciding the tokens, the interop and checkpoint round trips of the new
trees, and the paged layout's refusal.

JAX runs its jnp oracles (``kernel_backend="ref"``), the port its kernels'
plain versions (CPU tensors). Tolerances are f32 rtol=atol=1e-5 for
logits and caches, as in tests/test_torch_model.py; losses 1e-4 and router
gradients as in tests/test_torch_train.py. Routing decisions are held
equal by seeds whose token-router logits clear their thresholds and whose
image-router logits are apart by more than 1e-4 (``RouterMargins``,
``ContextMargins``).
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
from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import ElasticSpec as JaxSpec  # noqa: E402
from repro.core.policy import spec_from_config as jax_spec_from_config  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import model_init as jax_model_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import router_init as jax_router_init  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro.training import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ElasticConfig, get_config  # noqa: E402
from repro_torch.core.policy import ElasticPolicy, ElasticSpec  # noqa: E402
from repro_torch.core.policy import spec_from_config  # noqa: E402
from repro_torch.interop import (layered_to_numpy, params_from_numpy,  # noqa: E402
                                 params_to_numpy, train_state_from_tree,
                                 train_state_tree)
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.optimizer import tree_map  # noqa: E402
from repro_torch.training import (GenRequest, ServingEngine,  # noqa: E402
                                  init_train_state, make_loss_fn)
from tests.test_torch_interop import SPEC_KW, RouterMargins  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
# the slice's routers plus the image-token router (no experts: budget 1.0
# is then the teacher bit for bit)
VLM_KW = dict(SPEC_KW, vlm_routed=True)
ARCHS = ("toy-vlm", "llama-3.2-vision-11b")
SPECS = ("slice", "registered")


def f32(cfg):
    """A config (and its encoder's) in f32."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, dtype="float32"))
    return cfg


def specs(arch, which):
    """(JAX spec, port spec): ``slice`` = VLM_KW, ``registered`` = the
    arch's elastic config as the JAX package defines it (registered, or
    its default: moefied experts, LoRA, head top-k, context-token
    selection)."""
    if which == "slice":
        return (JaxSpec(**VLM_KW, kernel_backend="ref"), ElasticSpec(**VLM_KW))
    ecfg = jax_get_elastic(arch, jax_get_config(arch, "smoke"))
    t = spec_from_config(ElasticConfig(**dataclasses.asdict(ecfg)))
    return (dataclasses.replace(jax_spec_from_config(ecfg),
                                kernel_backend="ref"), t)


def context_pair(arch, which="slice", seed=0, lora_b=0.05, vlm_router=None,
                 spec_pair=None):
    """``arch``'s smoke variant built by the JAX package (f32) and the same
    weights and routers loaded into the port. LoRA B gets N(0, lora_b)
    noise so the adapter path does work; ``vlm_router="mlp"`` swaps in the
    MLP image-token router; ``spec_pair``: (JAX spec, port spec) in place
    of ``specs(arch, which)``."""
    jcfg = f32(jax_get_config(arch, "smoke"))
    tcfg = f32(get_config(arch, "smoke"))
    jspec, tspec = spec_pair or specs(arch, which)
    if vlm_router:
        jspec = dataclasses.replace(jspec, vlm_router=vlm_router)
        tspec = dataclasses.replace(tspec, vlm_router=vlm_router)
    key = jax.random.PRNGKey(seed)
    params = jax_model_init(key, jcfg, jspec)
    rp = jax_router_init(jax.random.fold_in(key, 1), jcfg, jspec)
    rng = np.random.default_rng(seed)
    rflat = {k: (rng.standard_normal(v.shape).astype(v.dtype) * lora_b
                 if "['lora']" in k and k.endswith("['b']") else v)
             for k, v in _flatten(rp).items()}
    rp = jax.tree.map(jnp.asarray, _unflatten_into(rp, rflat))
    flat = _flatten({"params": params, "routers": rp})
    tparams, trp = params_from_numpy(flat, tcfg, tspec, device="cpu")
    return dict(jcfg=jcfg, jspec=jspec, params=params, rp=rp, flat=flat,
                tcfg=tcfg, tspec=tspec, tparams=tparams, trp=trp)


def context_inputs(cfg, B, seed):
    """Seeded numpy context of ``cfg``'s family: ``image_embeds`` (VLM),
    ``frames`` (encoder-decoder) or ``embeds`` (encoder)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)}
    if cfg.encoder is not None:
        e = cfg.encoder
        return {"frames": rng.standard_normal(
            (B, e.encoder_seq, e.d_frontend or e.d_model)).astype(np.float32)}
    return {"embeds": rng.standard_normal(
        (B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def policies(budgets, cfg, static=False, spec=None):
    """The same budgets as a JAX and a port policy: one budget, static
    (Python-number leaves) or a () tensor per leaf; several, (B,) rows.
    Head top-k over ``cfg``'s heads, expert top-k over ``spec``'s moefied
    experts (when it has them)."""
    kw = dict(n_heads=cfg.n_heads,
              n_experts=spec.mlp_n_experts if spec is not None else None)
    if len(budgets) == 1:
        return (JaxPolicy.uniform(budgets[0], static=static, **kw),
                ElasticPolicy.uniform(budgets[0], static=static, **kw))
    return (JaxPolicy.stack([JaxPolicy.uniform(b, **kw) for b in budgets]),
            ElasticPolicy.stack([ElasticPolicy.uniform(b, **kw)
                                 for b in budgets]))


class ContextMargins:
    """Records, while installed, the smallest gap between two image-token
    router logits of one row in the port: the frameworks agree on them to
    ~1e-6, so a gap well above that means both select the same top-k."""

    def __init__(self, monkeypatch):
        self.gap = np.inf
        real = M._vlm_logits

        def rec(rp, emb):
            lg = real(rp, emb)
            srt = torch.sort(lg.detach(), dim=-1).values
            self.gap = min(self.gap, float((srt[..., 1:] - srt[..., :-1])
                                           .abs().min()))
            return lg
        monkeypatch.setattr(M, "_vlm_logits", rec)

    def check(self, margin=1e-4):
        assert self.gap > margin, f"two image-router logits sit {self.gap} apart"


@functools.lru_cache(maxsize=None)
def _pair(arch, which, seed=0):
    return context_pair(arch, which, seed)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("which", SPECS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,budget,static", [
    ("base", 1.0, False), ("infer", 1.0, False), ("infer", 0.5, False),
    ("infer", 0.5, True), ("train", 0.5, False), ("train", 0.5, True)],
    ids=["base", "infer-1.0", "infer-0.5", "infer-0.5-static",
         "train-0.5", "train-0.5-static"])
def test_forward_matches_jax(arch, which, mode, budget, static, monkeypatch):
    s = _pair(arch, which)
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 12, 1), **context_inputs(cfg, 2, 2)}
    jp, tp = policies([budget], cfg, static, s["tspec"])
    margins, cmargins = RouterMargins(monkeypatch), ContextMargins(monkeypatch)
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
        cmargins.check()


@pytest.mark.parametrize("router", ["linear", "mlp"])
@pytest.mark.parametrize("static,budgets", [
    (True, [0.6]), (True, [1.0]), (False, [0.6]), (False, [1.0]),
    (False, [0.5, 1.0])], ids=["static-0.6", "static-1.0", "tensor-0.6",
                               "tensor-1.0", "tensor-rows-0.5-1.0"])
def test_select_context_tokens_matches_jax(router, static, budgets,
                                           monkeypatch):
    """Static capacity: the gathered (B, k, D) subset, weighted; tensor:
    the full shape and the validity mask (per-row budgets; full rows keep
    every token at weight 1)."""
    s = context_pair("toy-vlm", "slice", seed=3, vlm_router=router)
    cfg = s["tcfg"]
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((len(budgets) if len(budgets) > 1 else 2,
                               cfg.n_image_tokens, cfg.d_model)).astype(
        np.float32)
    jp, tp = policies(budgets, cfg, static)
    cm = ContextMargins(monkeypatch)
    got, gv = M.select_context_tokens(s["trp"], torch.from_numpy(emb),
                                      s["tspec"], tp, "train")
    want, wv = jax_model.select_context_tokens(
        s["rp"], jnp.asarray(emb), s["jspec"], jp, "train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (gv is None) == (wv is None)
    if gv is not None:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert gv.shape == (emb.shape[0], cfg.n_image_tokens)
    if budgets == [1.0]:
        assert torch.equal(got, torch.from_numpy(emb))
        assert gv is None or bool(gv.all())
    elif static:
        assert got.shape[1] == int(np.ceil(budgets[0] * cfg.n_image_tokens))
    cm.check()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_jax(arch, monkeypatch):
    """Mixed per-row budgets: the ring caches of every layer (the ``xattn``
    layers' context K/V and selected rows too) and three decode steps."""
    s = _pair(arch, "registered")
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 10, 5), **context_inputs(cfg, 2, 6)}
    jp, tp = policies([0.5, 1.0], cfg, spec=s["tspec"])
    margins, cmargins = RouterMargins(monkeypatch), ContextMargins(monkeypatch)
    L = 24
    jl, jc = jax_prefill(s["params"], s["rp"], as_jax(batch), s["jcfg"],
                         s["jspec"], mode="infer", max_cache_len=L, policy=jp)
    tl, tc = prefill(s["tparams"], s["trp"], as_torch(batch), cfg,
                     s["tspec"], mode="infer", max_cache_len=L, policy=tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def check_caches():
        want = _flatten(jc)
        got = layered_to_numpy({}, cfg, None, {"c": tc})
        got = {k[len("['c']"):]: v for k, v in got.items()}
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if w.dtype == bool or w.dtype.kind == "i":
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)
    check_caches()
    valid = [v.reshape(-1, 2, v.shape[-1])[0] for k, v in _flatten(jc).items()
             if "['xattn']['valid']" in k]
    assert valid and not valid[0][0].all() and valid[0][1].all()
    t = np.asarray([10, 10], np.int32)
    for i in range(3):
        nxt = _tokens(cfg, 2, 1, 10 + i)
        jl, jc = jax_decode_step(s["params"], s["rp"], jnp.asarray(nxt), jc,
                                 jnp.asarray(t), s["jcfg"], s["jspec"],
                                 mode="infer", policy=jp)
        tl, tc = decode_step(s["tparams"], s["trp"], torch.from_numpy(nxt),
                             tc, torch.from_numpy(t), cfg, s["tspec"],
                             mode="infer", policy=tp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        t = t + 1
    check_caches()
    margins.check()
    cmargins.check()


def _jax_loss_and_grads(s, batch, jp):
    lf = jax_make_loss_fn(s["jcfg"], s["jspec"])
    (loss, m), g = jax.value_and_grad(lf, has_aux=True)(
        s["rp"], s["params"], as_jax(batch), jp)
    return loss, m, _flatten({"routers": g})


@pytest.mark.parametrize("static", [True, False], ids=["static", "tensor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_router_grads_match_jax(arch, static, monkeypatch):
    """A distillation step's loss, metrics and every router gradient (the
    image-token router's included) at budget 0.6, the image-token
    capacity static (gathered) or tensor (masked)."""
    s = _pair(arch, "registered")
    cfg = s["tcfg"]
    batch = {"tokens": _tokens(cfg, 2, 16, 7), **context_inputs(cfg, 2, 8)}
    jp, tp = policies([0.6], cfg, static, s["tspec"])
    jloss, jm, jg = _jax_loss_and_grads(s, batch, jp)
    cm = ContextMargins(monkeypatch)
    lf = make_loss_fn(cfg, s["tspec"])
    rp = tree_map(lambda t: t.clone().requires_grad_(True), s["trp"])
    loss, m = lf(rp, s["tparams"], as_torch(batch), tp)
    loss.backward()
    cm.check()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    for k in ("distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), **LOSS_TOL,
                                   err_msg=k)
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, rp)
    got = layered_to_numpy({}, cfg, s["tspec"], {"routers": grads})
    assert sorted(got) == sorted(jg)
    assert np.abs(got["['routers']['vlm']['w']"]).max() > 0
    for key, want in jg.items():
        scale = max(1e-3, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)


BATCH, MAX_SEQ, PLEN, NEW = 3, 32, 8, 6
BUDGETS = [1.0, 0.5, None, 0.75, 0.5]


def _staggered(engine, make_req, prompts, budgets, images, first=2):
    """Two requests, two steps, the rest: admissions land mid-decode. Each
    request carries its own image row as ``extra_inputs``."""
    handles = [engine.submit(make_req(p, NEW, budget=b),
                             extra_inputs={"image_embeds": im})
               for p, b, im in zip(prompts[:first], budgets[:first],
                                   images[:first])]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(make_req(p, NEW, budget=b),
                              extra_inputs={"image_embeds": im})
                for p, b, im in zip(prompts[first:], budgets[first:],
                                    images[first:])]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return [list(h.output) for h in handles]


def _workload(cfg, n=len(BUDGETS), seed=9):
    prompts = list(_tokens(cfg, n, PLEN, seed))
    imgs = context_inputs(cfg, n, seed + 1)["image_embeds"]
    return prompts, [imgs[i:i + 1] for i in range(n)]


def _port_engine(s, mode="infer", **kw):
    return ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         mode=mode, batch_size=BATCH, max_seq=MAX_SEQ,
                         device="cpu", **kw)


@pytest.mark.parametrize("which", SPECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch, which, monkeypatch):
    """The ring engine with one image per request (``extra_inputs``):
    staggered mixed-budget greedy tokens equal to the JAX engine's."""
    s = _pair(arch, which)
    prompts, images = _workload(s["tcfg"])
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"],
                     mode="infer", batch_size=BATCH, max_seq=MAX_SEQ)
    want = _staggered(jeng, JaxRequest, prompts, BUDGETS, images)
    margins, cm = RouterMargins(monkeypatch), ContextMargins(monkeypatch)
    got = _staggered(_port_engine(s), GenRequest, prompts, BUDGETS, images)
    margins.check()
    cm.check()
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_budget_one_is_the_teacher_bit_for_bit(arch):
    """Budget 1.0 (uniform, or one row of a mixed batch) reproduces
    mode="base" exactly with an image: the image-token router keeps every
    token at weight 1, and the engine's budget-1.0 requests give a base
    engine's tokens."""
    s = _pair(arch, "slice")
    cfg = s["tcfg"]
    batch = as_torch({"tokens": _tokens(cfg, 2, 12, 11),
                      **context_inputs(cfg, 2, 12)})
    base, _ = forward(s["tparams"], s["trp"], batch, cfg, s["tspec"],
                      mode="base")
    _, tp = policies([1.0, 0.5], cfg)
    mixed, _ = forward(s["tparams"], s["trp"], batch, cfg, s["tspec"],
                       mode="infer", policy=tp)
    assert torch.equal(mixed[0], base[0])
    assert not torch.equal(mixed[1], base[1])
    prompts, images = _workload(cfg)
    got = _staggered(_port_engine(s), GenRequest, prompts, BUDGETS, images)
    want = _staggered(_port_engine(s, mode="base"), GenRequest, prompts,
                      BUDGETS, images)
    full = [i for i, b in enumerate(BUDGETS) if b == 1.0 or b is None]
    assert [got[i] for i in full] == [want[i] for i in full]


@pytest.mark.parametrize("which", SPECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_equals_solo(arch, which):
    s = _pair(arch, which)
    prompts, images = _workload(s["tcfg"])
    got = _staggered(_port_engine(s), GenRequest, prompts, BUDGETS, images)
    for i in (1, 3):
        solo = _port_engine(s).generate(
            [GenRequest(prompts[i], NEW, budget=BUDGETS[i])],
            extra_inputs={"image_embeds": images[i]})
        assert list(solo[0]) == got[i]


def test_the_image_decides_the_tokens():
    """The same prompt with two images gives different tokens, with the
    same image the same tokens; a slot's context cache holds its own
    request's image (written in place at admission)."""
    s = _pair("toy-vlm", "slice")
    cfg = s["tcfg"]
    prompt = _tokens(cfg, 1, PLEN, 13)[0]
    imgs = context_inputs(cfg, 2, 14)["image_embeds"]
    eng = _port_engine(s)
    caches = eng._caches
    xk = caches["layers"][1]["xattn"]["k"]
    ptr = xk.data_ptr()
    reqs = [GenRequest(prompt, NEW, budget=0.5) for _ in range(3)]
    out = eng.generate(reqs, extra_inputs={"image_embeds": np.concatenate(
        [imgs[:1], imgs[1:2], imgs[:1]])})
    assert list(out[0]) == list(out[2]) and list(out[0]) != list(out[1])
    assert eng._caches["layers"][1]["xattn"]["k"].data_ptr() == ptr
    assert not torch.equal(xk[0], xk[1]) and torch.equal(xk[0], xk[2])
    assert eng._extras == {}


def test_extras_are_dropped_on_cancel():
    s = _pair("toy-vlm", "slice")
    cfg = s["tcfg"]
    prompts, images = _workload(cfg, n=2)
    eng = _port_engine(s)
    h = [eng.submit(GenRequest(p, NEW), extra_inputs={"image_embeds": im})
         for p, im in zip(prompts, images)]
    assert sorted(eng._extras) == sorted(x.id for x in h)
    eng.cancel(h[1])
    assert sorted(eng._extras) == [h[0].id]
    while not h[0].done:
        eng.step()
    assert eng._extras == {}


@pytest.mark.parametrize("extra", [
    None, {}, {"frames": 0}, {"image_embeds": 0, "frames": 0},
    {"image_embeds": (2, 0, 0)}, {"image_embeds": (1, -1, 0)},
    {"image_embeds": (1, 0, 1)}],
    ids=["none", "empty", "wrong-key", "extra-key", "two-rows",
         "short-image", "wide-image"])
def test_submit_refuses_bad_extra_inputs(extra):
    """A VLM request whose ``extra_inputs`` lack one (1, n_image_tokens,
    d_frontend) ``image_embeds`` row is refused at submit: nothing is
    queued and no extras are kept; a good row is taken."""
    s = _pair("toy-vlm", "slice")
    cfg = s["tcfg"]
    prompts, images = _workload(cfg, n=1)
    good = (1, cfg.n_image_tokens, cfg.d_frontend)
    if extra:       # a shape (offsets from the good one) or a good row
        extra = {k: np.zeros(tuple(g + d for g, d in zip(good, v)),
                             np.float32) if isinstance(v, tuple)
                 else images[0] for k, v in extra.items()}
    eng = _port_engine(s)
    with pytest.raises(ValueError, match="image_embeds"):
        eng.submit(GenRequest(prompts[0], NEW), extra_inputs=extra)
    assert not eng.has_work and eng._extras == {}
    h = eng.submit(GenRequest(prompts[0], NEW),
                   extra_inputs={"image_embeds": images[0]})
    assert eng.has_work and list(eng._extras) == [h.id]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_layout_refuses_the_vlm(arch):
    s = _pair(arch, "slice")
    with pytest.raises(ValueError, match="decoder-only"):
        _port_engine(s, kv_layout="paged", page_size=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_routers_and_train_state_round_trip(arch, tmp_path):
    """The new trees (``in_proj``, ``xnorm``/``xattn``, the ``vlm``
    router) carried from JAX and back bit for bit, and a train state of
    them through the port's Checkpointer."""
    s = _pair(arch, "registered")
    cfg, spec = s["tcfg"], s["tspec"]
    back = params_to_numpy(s["tparams"], s["trp"], cfg, spec)
    assert sorted(back) == sorted(s["flat"])
    assert "['params']['in_proj']" in back and any(
        "['xattn']['wq']" in k for k in back)
    assert "['routers']['vlm']['w']" in back
    for k, v in s["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    state = init_train_state(s["trp"])
    ck = Checkpointer(str(tmp_path))
    ck.save(3, train_state_tree(state, cfg, spec),
            extra={"opt_step": 0}, blocking=True)
    like = tree_map(torch.zeros_like, train_state_tree(state, cfg, spec))
    loaded, extra = ck.restore(3, like)
    got = train_state_from_tree(loaded, extra["opt_step"], cfg, spec)
    assert sorted(got.router_params) == sorted(s["trp"])
    want = layered_to_numpy({}, cfg, spec, {"r": s["trp"]})
    have = layered_to_numpy({}, cfg, spec, {"r": got.router_params})
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_refusals_name_their_roadmap_item():
    """Padded q-heads build on the CPU (item 11's first half); a context
    family on a mesh still waits, naming item 11."""
    from repro_torch.runtime.mesh import abstract_mesh
    from repro_torch.models import blocks
    from repro_torch.models.model import check_mesh
    padded = get_config("toy-vlm", "smoke", head_pad=16)
    p = blocks.block_init(torch.Generator(), "xattn", padded, device="cpu")
    assert p["xattn"]["wq"].shape[1] == padded.n_heads_p == 16
    with pytest.raises(NotImplementedError, match="item 11"):
        with abstract_mesh((1, 2), ("data", "model")):
            check_mesh(get_config("toy-vlm", "smoke"), None)
    with pytest.raises(ValueError, match="self-attention"):
        blocks.block_paged_cache_init("xattn", get_config("toy-vlm", "smoke"),
                                      4, 8, device="cpu")
