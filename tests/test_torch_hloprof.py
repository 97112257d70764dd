"""The port's FLOP and byte accounting (``repro_torch.launch.hloprof``) and
the kernels' cost model (``ops.kernel_cost``), on the CPU at toy sizes.

* The counterparts of tests/test_hloprof.py's four tests: tensor bytes,
  views skipped as HLO's bookkeeping ops are, ``biggest_tensors`` largest
  first, ``top_table`` renders.
* ``cache_read_bytes`` of the port's engine equals the JAX package's
  ``hloprof.cache_read_bytes`` of its compiled decode step EXACTLY, for
  toy-lm ring fp32, ring int8 and paged int8.
* ``kernel_cost`` of a dense ``fused_mlp`` equals ``FlopCounterMode``'s
  count of its plain version; one wrapper call is counted exactly once,
  and nothing its plain version runs reaches the op recorder.
* ``lowered_flops`` of the toy forward falls strictly with the token and
  the depth budget and composes them, as tests/test_ragged.py and
  tests/test_depth.py require of the JAX package's; its ratios against
  budget 1.0 agree with the JAX package's within 0.05 (see
  ``RATIO_TOL``).
* ``bytes_moved`` falls with the budget among the routed budgets.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs.elasti_toy import toy_lm as jax_toy_lm  # noqa: E402
from repro.core.policy import ElasticPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import ElasticSpec as JaxSpec  # noqa: E402
from repro.launch import hloprof as jax_hloprof  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import model_init as jax_model_init  # noqa: E402
from repro.models import router_init as jax_router_init  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.elasti_toy import toy_lm  # noqa: E402
from repro_torch.core.policy import ElasticPolicy, ElasticSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import fused_mlp_ref  # noqa: E402
from repro_torch.launch import hloprof  # noqa: E402
from repro_torch.models import forward, model_init, router_init  # noqa: E402
from repro_torch.training import ServingEngine  # noqa: E402

# XLA's cost analysis counts every elementwise operation and the whole
# (S x S) score matrix of the jnp attention; the port counts matrix
# products (torch.utils.flop_counter) and the attended (query, key) pairs
# (ops.kernel_cost). The fixed parts (the LM head, the routers) weigh
# differently in the two totals, so at S = 256 the FLOP ratios against
# budget 1.0 differ by up to ~0.045 (0.25 token budget); 0.05 bounds it.
RATIO_TOL = 0.05
S = 256
BUDGETS = (1.0, 0.75, 0.5, 0.25)


# ------------------------ the counterparts of test_hloprof --------------------

def _program(x, w):
    y = x @ w                                  # one product: (16, 64) f32
    z = y.reshape(4, 4, 64).transpose(0, 1)    # views: nothing moves
    return (z.to(torch.bfloat16).float() + 1.0).sum()


X, W = torch.ones(16, 32), torch.ones(32, 64)


def test_tensor_bytes():
    assert hloprof.tensor_bytes(((16, 4096, 3584), torch.float32)) \
        == 16 * 4096 * 3584 * 4
    assert hloprof.tensor_bytes(((128, 128), torch.bfloat16)) \
        == 128 * 128 * 2
    assert hloprof.tensor_bytes(torch.zeros(2, 2),
                                torch.zeros(4, dtype=torch.int32)) == 16 + 16


def test_profile_skips_views():
    prof = hloprof.profile_ops(_program, X, W)
    assert not any(k.startswith(("aten.view", "aten.transpose",
                                 "aten._unsafe_view")) for k in prof)
    assert prof["aten.mm.default"] == {
        "count": 1, "bytes": 16 * 64 * 4,
        "moved": 16 * 64 * 4 + 16 * 32 * 4 + 32 * 64 * 4}
    assert prof["aten._to_copy.default"]["count"] == 2   # to bf16 and back


def test_biggest_tensors_sorted_desc():
    top = hloprof.biggest_tensors(hloprof.record_ops(_program, X, W), n=3)
    assert top[0][0] >= top[1][0] >= top[2][0]
    assert top[0][0] == 16 * 64 * 4            # the f32 (16, 64) outputs


def test_top_table_renders():
    out = hloprof.top_table(hloprof.profile_ops(_program, X, W))
    assert "aten.mm.default" in out and "TOTAL" in out


# ------------------------------ cache_read_bytes ------------------------------

def _jax_cache_read_bytes(layout, kv_dtype):
    cfg = dataclasses.replace(jax_toy_lm(), dtype="float32")
    spec = JaxSpec(kernel_backend="ref")
    key = jax.random.PRNGKey(0)
    eng = JaxEngine(jax_model_init(key, cfg, spec),
                    jax_router_init(jax.random.fold_in(key, 1), cfg, spec),
                    cfg, spec, batch_size=2, max_seq=48, kv_layout=layout,
                    page_size=8, kv_dtype=kv_dtype)
    ep = eng.entry_points()["decode"]
    hlo = ep.fn.lower(*ep.args, **ep.static).compile().as_text()
    return jax_hloprof.cache_read_bytes(hlo, eng._caches)


@pytest.mark.parametrize("layout,kv_dtype", [("ring", "fp32"),
                                             ("ring", "int8"),
                                             ("paged", "int8")])
def test_cache_read_bytes_equals_jax(layout, kv_dtype):
    cfg = dataclasses.replace(toy_lm(), dtype="float32")
    spec = ElasticSpec()
    gen = torch.Generator().manual_seed(0)
    eng = ServingEngine(model_init(gen, cfg, spec, device="cpu"),
                        router_init(gen, cfg, spec, device="cpu"), cfg, spec,
                        batch_size=2, max_seq=48, kv_layout=layout,
                        page_size=8, kv_dtype=kv_dtype, device="cpu")
    got = hloprof.cache_read_bytes(eng)
    assert got == _jax_cache_read_bytes(layout, kv_dtype)
    if kv_dtype == "int8":                     # the f32 scales are counted
        assert got > sum(t.numel() for layer in eng._caches["layers"]
                         for t in layer["attn"].values())


# ------------------------------ kernel_cost -----------------------------------

def _mlp_args(B=2, T=24, D=64, F=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, T, D, generator=g),
            torch.randn(D, F, generator=g) / D ** 0.5,
            torch.randn(F, D, generator=g) / F ** 0.5,
            torch.randn(D, F, generator=g) / D ** 0.5)


def test_kernel_cost_of_dense_mlp_is_flop_counters():
    x, wi, wo, wg = _mlp_args()
    flops, nbytes, kind = ops.kernel_cost("fused_mlp", x, wi, wo, wg)
    with FlopCounterMode(display=False) as fc:
        fused_mlp_ref(x, wi, wo, wg)
    assert flops == fc.get_total_flops() == 2 * 2 * 24 * 64 * 96 * 3
    assert kind == "f32"
    # the weights once, every x row read and every output row written,
    # and the (B,) counts
    assert nbytes == 3 * 64 * 96 * 4 + 2 * x.numel() * 4 + 2 * 4
    # a count: only the live rows' products
    live = ops.kernel_cost("fused_mlp", x, wi, wo, wg,
                           valid_count=torch.tensor([24, 6]))[0]
    assert live == 2 * (24 + 6) * 64 * 96 * 3


def test_one_wrapper_call_is_counted_once():
    x, wi, wo, wg = _mlp_args()
    recs = hloprof.record_ops(lambda: ops.fused_mlp(x, wi, wo, wg))
    calls = [r for r in recs if isinstance(r, ops.KernelCall)]
    assert len(calls) == 1 and calls[0].name == "fused_mlp"
    assert not [r for r in recs if isinstance(r, hloprof.OpRecord)], \
        "the plain version's operations reached the recorder"
    assert hloprof.lowered_flops(lambda: ops.fused_mlp(x, wi, wo, wg)) \
        == ops.kernel_cost("fused_mlp", x, wi, wo, wg)[0]
    assert calls[0].out_bytes == x.numel() * 4


def test_backward_replay_is_recorded(monkeypatch):
    """On the card a training step's backward replays the kernel's plain
    version (``KernelOp``): real device work, which the recorder counts,
    while the forward launch counts as its one kernel call. The launch is
    faked here (CPU tensors on the kernel path)."""
    import contextlib

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0
    monkeypatch.setattr(ops, "use_kernel", lambda backend, t: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "load", lambda name: Lib())
    monkeypatch.setattr(ops.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    x, wi, wo, wg = _mlp_args()
    x.requires_grad_(True)

    def step():
        ops.fused_mlp(x, wi, wo, wg).sum().backward()
    recs = hloprof.record_ops(step)
    names = [r.name for r in recs]
    assert names.count("fused_mlp") == 1
    assert any(n.startswith("aten.mm") for n in names)   # the replay
    assert x.grad is not None


# ------------------------- lowered_flops, bytes_moved -------------------------

@functools.lru_cache(maxsize=None)
def _toys():
    kw = dict(mha_token_routed=True, mlp_token_routed=True,
              depth_routed=True)
    jcfg = dataclasses.replace(jax_toy_lm(vocab=256), dtype="float32")
    jspec = JaxSpec(**kw)
    key = jax.random.PRNGKey(0)
    jax_side = (jcfg, jspec, jax_model_init(key, jcfg, jspec),
                jax_router_init(jax.random.fold_in(key, 1), jcfg, jspec))
    cfg = dataclasses.replace(toy_lm(vocab=256), dtype="float32")
    spec = ElasticSpec(**kw)
    g = torch.Generator().manual_seed(0)
    port = (cfg, spec, model_init(g, cfg, spec, device="cpu"),
            router_init(g, cfg, spec, device="cpu"))
    return jax_side, port


@functools.lru_cache(maxsize=None)
def _port(depth, token, count=hloprof.lowered_flops):
    cfg, spec, params, rp = _toys()[1]
    pol = ElasticPolicy.uniform(token, static=True).replace(
        depth_capacity=depth)
    batch = {"tokens": torch.zeros((2, S), dtype=torch.int64)}
    with torch.no_grad():
        return count(lambda: forward(params, rp, batch, cfg, spec,
                                     mode="train", policy=pol)[0])


@functools.lru_cache(maxsize=None)
def _jax(depth, token):
    cfg, spec, params, rp = _toys()[0]
    pol = JaxPolicy.uniform(token, static=True).replace(depth_capacity=depth)
    return jax_hloprof.lowered_flops(
        lambda rp, b: jax_forward(params, rp, b, cfg, spec, mode="train",
                                  policy=pol)[0],
        rp, {"tokens": jnp.zeros((2, S), jnp.int32)})


@pytest.mark.parametrize("knob", ["token", "depth"])
def test_lowered_flops_track_the_budget_as_jax(knob):
    at = (lambda b: (1.0, b)) if knob == "token" else (lambda b: (b, 1.0))
    fl = {b: _port(*at(b)) for b in BUDGETS}
    assert fl[1.0] > fl[0.75] > fl[0.5] > fl[0.25], fl
    assert fl[0.5] <= 0.6 * fl[1.0], fl
    jx = {b: _jax(*at(b)) for b in (1.0, 0.5, 0.25)}
    for b in (0.5, 0.25):
        assert abs(fl[b] / fl[1.0] - jx[b] / jx[1.0]) <= RATIO_TOL, \
            (b, fl, jx)


def test_lowered_flops_compose_depth_and_token():
    both = _port(0.5, 0.5)
    assert both < _port(0.5, 1.0) and both < _port(1.0, 0.5)


def test_bytes_moved_falls_with_the_budget():
    """Among the routed budgets the bytes fall with the budget. Budget 1.0
    takes the identity path (no plan: no sort, gather or scatter), so at
    this toy size 0.75's plan costs more bytes than the rows it drops:
    only 0.5 and below are held under 1.0."""
    mb = {b: _port(1.0, b, hloprof.bytes_moved) for b in BUDGETS}
    assert mb[0.75] > mb[0.5] > mb[0.25], mb
    assert mb[0.5] < mb[1.0], mb


def test_step_shares_and_bound():
    assert hloprof.bound_ms(989e9, 1.0, "bf16") == (1.0, "operations")
    ms, by = hloprof.bound_ms(1.0, 3.35e9, "bf16")
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    sh = hloprof.step_shares({"bf16": 989e9, "f32": 67e9}, 3.35e9, 4.0)
    assert abs(sh["mfu"] - 0.5) < 1e-12 and abs(sh["hbm_share"] - 0.25) < 1e-12
    assert np.isclose(hloprof.step_shares(989e9, 0.0, 1.0, "bf16")["mfu"], 1.0)
