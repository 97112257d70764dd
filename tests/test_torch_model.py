"""The port's model against the JAX package's, at toy-lm size in f32, with
token routing around attention and the MLP, head top-k and LoRA rank 1.

JAX runs its Pallas kernels in interpret mode (``kernel_backend=
"interpret"``), the port its kernels' plain versions (CPU tensors). Logits
and caches are held to f32 rtol=atol=1e-5; the routing decisions are held
equal by seeds whose router logits clear their thresholds by more than
1e-4 (asserted: the frameworks agree to ~1e-6 on those logits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.core.policy import ElasticPolicy  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from tests.test_torch_interop import RouterMargins, toy_pair  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BUDGETS = [1.0, 0.75, 0.5, 0.25]
N_HEADS = 4


@pytest.fixture(scope="module")
def setup():
    s = toy_pair(seed=0)
    rng = np.random.default_rng(0)
    s["tokens"] = rng.integers(0, s["tcfg"].vocab_size, (2, 24),
                               dtype=np.int64).astype(np.int32)
    jcfg, jspec = s["jcfg"], s["jspec"]
    s["jfwd"] = {
        mode: jax.jit(lambda p, r, b, pol, mode=mode: jax_forward(
            p, r, b, jcfg, jspec, mode=mode, policy=pol)[0])
        for mode in ("base", "infer")}
    return s


def _policies(budgets):
    """The same per-row budgets as a JAX and a port policy, (B,) leaves."""
    jp = JaxPolicy.stack([JaxPolicy.uniform(b, n_heads=N_HEADS)
                          for b in budgets])
    tp = ElasticPolicy.stack([ElasticPolicy.uniform(b, n_heads=N_HEADS)
                              for b in budgets])
    return jp, tp


@pytest.mark.parametrize("mode,budget", [("base", None)] + [
    ("infer", b) for b in BUDGETS])
def test_forward_logits_match_jax(setup, monkeypatch, mode, budget):
    s = setup
    margins = RouterMargins(monkeypatch)
    jp, tp = _policies([budget or 1.0] * 2)
    tok = s["tokens"]
    got, aux = forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(
        tok)}, s["tcfg"], s["tspec"], mode=mode, policy=tp)
    want = s["jfwd"][mode](s["params"], s["rp"], {"tokens": jnp.asarray(tok)},
                           jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "infer":
        margins.check()
        if budget < 1.0:        # the routers dropped tokens
            assert float(aux.sel_rate) < 1.0


def test_prefill_caches_and_decode_logits_match_jax(setup, monkeypatch):
    """Mixed per-row budgets: prefill caches (ring layout, max_cache_len >
    prompt) and three per-row decode steps, logits and caches."""
    s = setup
    margins = RouterMargins(monkeypatch)
    jp, tp = _policies([0.5, 1.0])
    tok = s["tokens"][:, :12]
    L = 32
    jl, jc = jax_prefill(s["params"], s["rp"], {"tokens": jnp.asarray(tok)},
                         s["jcfg"], s["jspec"], mode="infer",
                         max_cache_len=L, policy=jp)
    tl, tc = prefill(s["tparams"], s["trp"], {"tokens": torch.from_numpy(
        tok)}, s["tcfg"], s["tspec"], mode="infer", max_cache_len=L,
        policy=tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def check_caches():
        for i, layer in enumerate(tc["layers"]):
            ja = jax.tree.map(lambda a: np.asarray(a[i]), jc["scan"][0])
            for name in ("k", "v"):
                np.testing.assert_allclose(layer["attn"][name].numpy(),
                                           ja["attn"][name], **TOL)
            for name in ("valid", "pos"):
                np.testing.assert_array_equal(layer["attn"][name].numpy(),
                                              ja["attn"][name])
    check_caches()
    assert not np.asarray(jc["scan"][0]["attn"]["valid"][:, 0]).all()

    rng = np.random.default_rng(1)
    t = np.asarray([12, 12], np.int32)
    for _ in range(3):
        nxt = rng.integers(0, s["tcfg"].vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jax_decode_step(s["params"], s["rp"], jnp.asarray(nxt), jc,
                                 jnp.asarray(t), s["jcfg"], s["jspec"],
                                 mode="infer", policy=jp)
        tl, tc = decode_step(s["tparams"], s["trp"], torch.from_numpy(nxt),
                             tc, torch.from_numpy(t), s["tcfg"], s["tspec"],
                             mode="infer", policy=tp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        t = t + 1
    check_caches()
    margins.check()


def test_budget_one_is_the_teacher_bit_for_bit(setup):
    """Budget 1.0 (uniform or one row of a mixed batch) reproduces
    mode="base" exactly: token weights, head weights and the LoRA gate all
    become exact identities."""
    s = setup
    tok = {"tokens": torch.from_numpy(s["tokens"])}
    run = lambda mode, pol: forward(s["tparams"], s["trp"], tok, s["tcfg"],
                                    s["tspec"], mode=mode, policy=pol)[0]
    base = run("base", None)
    assert torch.equal(run("infer", ElasticPolicy.uniform(1.0,
                                                          n_heads=N_HEADS)),
                       base)
    assert torch.equal(run("infer", ElasticPolicy.uniform(
        1.0, n_heads=N_HEADS, static=True)), base)
    _, mixed = _policies([1.0, 0.5])
    out = run("infer", mixed)
    assert torch.equal(out[0], base[0])
    assert not torch.equal(out[1], base[1])


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_per_layer_schedule_matches_jax(mode, monkeypatch):
    """(L, 1) depth and token schedules (tests/test_policy.py:145-158 with
    depth routed): ``has_layer_dim`` / ``for_layer`` as in JAX, and the
    logits of a scheduled forward within 1e-5 of JAX's."""
    from tests.test_torch_interop import SPEC_KW
    s = toy_pair(seed=0, spec_kw=dict(SPEC_KW, depth_routed=True))
    L = s["tcfg"].n_layers
    caps = np.linspace(0.4, 1.0, L, dtype=np.float32)[:, None]
    depth = np.linspace(1.0, 0.5, L, dtype=np.float32)[:, None]
    jp = JaxPolicy.uniform(1.0, n_heads=N_HEADS).replace(
        mlp_token_capacity=jnp.asarray(caps),
        mha_token_capacity=jnp.asarray(caps),
        depth_capacity=jnp.asarray(depth))
    tp = ElasticPolicy.uniform(1.0, n_heads=N_HEADS).replace(
        mlp_token_capacity=torch.from_numpy(caps),
        mha_token_capacity=torch.from_numpy(caps),
        depth_capacity=torch.from_numpy(depth))
    assert tp.has_layer_dim and jp.has_layer_dim
    assert not ElasticPolicy.uniform(0.5).has_layer_dim
    assert not ElasticPolicy.stack([ElasticPolicy.uniform(0.5)] * 2
                                   ).has_layer_dim
    for i in (0, L - 1, L + 1):
        jl, tl = jp.for_layer(i), tp.for_layer(i)
        for f in ("mlp_token_capacity", "depth_capacity", "theta"):
            np.testing.assert_array_equal(np.asarray(getattr(tl, f)),
                                          np.asarray(getattr(jl, f)))
    assert tp.for_layer(0).mlp_token_capacity.shape == (1,)
    margins = RouterMargins(monkeypatch)
    tok = np.random.default_rng(5).integers(
        0, s["tcfg"].vocab_size, (2, 24)).astype(np.int32)
    want, jaux = jax_forward(s["params"], s["rp"], {"tokens": jnp.asarray(
        tok)}, s["jcfg"], s["jspec"], mode=mode, policy=jp)
    got, taux = forward(s["tparams"], s["trp"], {"tokens": torch.from_numpy(
        tok)}, s["tcfg"], s["tspec"], mode=mode, policy=tp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux.sel_rate), float(jaux.sel_rate),
                               **TOL)
    assert 0.2 < float(taux.sel_rate) < 1.0
    if mode == "infer":
        margins.check()
