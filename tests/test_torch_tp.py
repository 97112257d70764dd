"""Tensor-parallel serving on a (data=1, model=2) mesh against the JAX
package's one-device results.

One H100 can test only the collective logic of tensor parallelism (two
ranks on one card share it), so these tests run that logic with gloo on
CPU processes: one group of two ranks, spawned once per module by a
fixture that runs every case and returns its results. Each rank loads the
JAX weights through ``interop.params_from_numpy(mesh=)`` (its heads, MLP
columns and vocabulary rows), runs the kernels' plain versions on them
and completes the partial sums with ``all_reduce_sum`` / ``all_gather``.

Held, on smoke Qwen2 (2 layers, 4 q-heads on 2 kv-heads, f32) with token
routing, head top-k and LoRA: ``forward`` in base / infer / train mode,
``prefill`` then ``decode_step`` (logits and each rank's cache slice), and
a staggered ring engine, against JAX (``kernel_backend="ref"``) on the
same weights: logits within 1e-5, greedy tokens identical (JAX's own test
asserts its mesh engine equals its one-device engine,
tests/test_sharding_multidev.py:135-140). Within the port under TP:
budget 1.0 == the teacher, staggered == solo, the same RoutingPlan on
every rank (``Mesh(debug=True)``), the per-rank kernel shapes (B, 1, H/M,
Dh) and (D, F/M) as ``ops.recording`` sees them (JAX's ``seen``,
tests/test_sharding_multidev.py:213, 239), with their ``kernel_cost`` and
launch geometry, one decode signature at every budget. Padded q-heads (6
heads padded to 8) against JAX on one process and under TP 2. The mesh
engine's refusals.
"""
import dataclasses
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.core.policy import ElasticPolicy, ElasticSpec  # noqa: E402
from repro_torch.interop import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.launch.mesh import destroy, make_mesh  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.models.attention import check_kernel_ok  # noqa: E402
from repro_torch.runtime import collectives as C  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.runtime.mesh import Mesh, abstract_mesh  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from repro_torch.training import serve as serve_mod  # noqa: E402

M = 2
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, MAX_SEQ, PLEN, NEW = 3, 40, 10, 6
BUDGETS = [1.0, 0.5, None, 0.75, 0.5]
SOLO = (1, 3)
SIG_BUDGETS = (1.0, 0.75, 0.5)     # one request alone at each
CACHE_LEN, PREFILL_LEN, DECODE_STEPS = 32, 12, 3
SPEC_KW = dict(mlp_token_routed=True, mha_token_routed=True,
               mha_head_routed=True, lora_rank=1)
# the smoke Qwen2 and its padded twin (6 q-heads padded to 8: 4 a rank)
CASES = {"main": {}, "padded": dict(n_heads=6, head_pad=4)}
MODES = ("base", "infer", "train")


def _cfg(get, case):
    return dataclasses.replace(get("qwen2-7b", "smoke"), dtype="float32",
                               n_layers=2, **CASES[case])


def _policies(policy_cls, n_heads):
    """Each mode's policy in either package: the teacher none, infer a
    mixed (1.0, 0.5) tensor policy, train a static 0.5 (the plan path
    through the routed MLP)."""
    return {"base": None,
            "infer": policy_cls.stack([policy_cls.uniform(b, n_heads=n_heads)
                                       for b in (1.0, 0.5)]),
            "train": policy_cls.uniform(0.5, n_heads=n_heads, static=True)}


def _staggered(engine, make_req, prompts, budgets):
    """Two requests, two steps, the rest: admissions land mid-decode."""
    handles = [engine.submit(make_req(p, NEW, budget=b))
               for p, b in zip(prompts[:2], budgets[:2])]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(make_req(p, NEW, budget=b))
                for p, b in zip(prompts[2:], budgets[2:])]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return [[int(t) for t in h.output] for h in handles]


class _Margins:
    """The smallest distance of a token router's logit from its threshold
    seen while installed (the frameworks agree to ~1e-6 on those logits,
    so a margin well above that means they take the same decisions)."""

    def __init__(self):
        self.token = np.inf
        self._real = R.token_logits

        def token_logits(rp, x):
            lg = self._real(rp, x)
            self.token = min(self.token, float(lg.abs().min()))
            return lg
        R.token_logits = token_logits

    def close(self) -> float:
        R.token_logits = self._real
        return self.token


# ------------------------------- the ranks ----------------------------------

def _engine(params, rp, cfg, spec, mesh, mode="infer"):
    return ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=BATCH,
                         max_seq=MAX_SEQ, device="cpu", mesh=mesh)


def _rank_case(mesh, c, full: bool) -> dict:
    cfg, spec = c["cfg"], c["spec"]
    params, rp = params_from_numpy(c["flat"], cfg, spec, device="cpu",
                                   mesh=mesh)
    out = {"wq": tuple(params["layers"][0]["attn"]["wq"].shape),
           "embed": tuple(params["embed"].shape)}
    tok = torch.from_numpy(c["tokens"])
    pols = _policies(ElasticPolicy, cfg.n_heads)
    checked = []
    real_check = C.assert_replicated
    C.assert_replicated = lambda x, what, m=None: (
        checked.append(what), real_check(x, what, m))
    try:
        with mesh, OPS.recording() as calls:
            for mode in MODES:
                out[f"fwd_{mode}"] = forward(
                    params, rp, {"tokens": tok}, cfg, spec, mode=mode,
                    policy=pols[mode])[0].detach().numpy()
            if full:
                lg, caches = prefill(
                    params, rp, {"tokens": tok[:, :PREFILL_LEN]}, cfg, spec,
                    mode="infer", max_cache_len=CACHE_LEN,
                    policy=pols["infer"])
                out["prefill"] = lg.numpy()
                t = torch.full((2,), PREFILL_LEN, dtype=torch.int32)
                for i in range(DECODE_STEPS):
                    lg, caches = decode_step(
                        params, rp, torch.from_numpy(c["dec_tokens"][i]),
                        caches, t + i, cfg, spec, mode="infer",
                        policy=pols["infer"])
                    out[f"decode{i}"] = lg.numpy()
                out["caches"] = [{k: v.numpy() for k, v in la["attn"].items()}
                                 for la in caches["layers"]]
        out["calls"] = [(cl.name, {k: tuple(v.shape) for k, v in
                                   cl.args.items() if torch.is_tensor(v)},
                         cl.cost, OPS.launch_geometry(cl.name, **cl.args))
                        for cl in calls]
    finally:
        C.assert_replicated = real_check
    out["plans_checked"] = len(checked)

    # the decode step's kernel calls (launch signatures) of each run: the
    # staggered mixed-budget one, then one request alone at each budget
    sigs, run = {}, ["staggered"]
    real_step = serve_mod.decode_step

    def recording_step(*a, **kw):
        with OPS.recording(cost=False) as calls:
            res = real_step(*a, **kw)
        sigs.setdefault(run[0], set()).update(map(OPS.call_signature, calls))
        return res

    serve_mod.decode_step = recording_step
    try:
        eng = _engine(params, rp, cfg, spec, mesh)
        margins = _Margins()
        try:
            out["staggered"] = _staggered(eng, GenRequest, c["prompts"],
                                          BUDGETS)
        finally:
            out["margin"] = margins.close()
        for b in SIG_BUDGETS:
            run[0] = b
            eng.generate([GenRequest(c["prompts"][0], 3, budget=b)])
        out["compiles"] = eng.compile_counts()
    finally:
        serve_mod.decode_step = real_step
    out["decode_signatures"] = sigs
    if full:
        out["teacher"] = _staggered(_engine(params, rp, cfg, spec, mesh,
                                            "base"),
                                    GenRequest, c["prompts"], [None] * 5)
        out["solo"] = {i: [int(t) for t in _engine(
            params, rp, cfg, spec, mesh).generate(
                [GenRequest(c["prompts"][i], NEW, budget=BUDGETS[i])])[0]]
            for i in SOLO}
    return out


def _rank(rank: int, port: int, d: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(f"{d}/in.pt", weights_only=False)
    mesh = make_mesh((1, M), ("data", "model"), backend="gloo", rank=rank,
                     init_method=f"tcp://localhost:{port}", debug=True,
                     timeout=120)
    try:
        out = {name: _rank_case(mesh, c, name == "main")
               for name, c in inp.items()}
    finally:
        destroy(mesh)
    torch.save(out, f"{d}/rank{rank}.pt")


# ------------------------------ JAX's side ----------------------------------

def _jax_case(case: str):
    """The case built by the JAX package (LoRA B filled with noise so the
    adapter works) and the inputs the ranks take; then, as a generator's
    second step, its results on one device."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import _flatten, _unflatten_into
    from repro.configs import get_config as jax_get_config
    from repro.core.policy import ElasticPolicy as JaxPolicy
    from repro.core.policy import ElasticSpec as JaxSpec
    from repro.models import decode_step as jax_decode_step
    from repro.models import forward as jax_forward
    from repro.models import model_init as jax_model_init
    from repro.models import prefill as jax_prefill
    from repro.models import router_init as jax_router_init
    from repro.training import GenRequest as JaxRequest
    from repro.training import ServingEngine as JaxEngine

    jcfg, cfg = _cfg(jax_get_config, case), _cfg(get_config, case)
    jspec = JaxSpec(**SPEC_KW, kernel_backend="ref")
    key = jax.random.PRNGKey(7)
    params = jax_model_init(key, jcfg, jspec)
    rp = jax_router_init(jax.random.fold_in(key, 1), jcfg, jspec)
    rng = np.random.default_rng(7)
    rflat = {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.05
                 if "['lora']" in k and k.endswith("['b']") else v)
             for k, v in _flatten(rp).items()}
    rp = jax.tree.map(jnp.asarray, _unflatten_into(rp, rflat))
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, PLEN).astype(np.int32)
               for _ in BUDGETS]
    dec = [rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
           for _ in range(DECODE_STEPS)]
    yield dict(flat=_flatten({"params": params, "routers": rp}), cfg=cfg,
               spec=ElasticSpec(**SPEC_KW), tokens=tokens, prompts=prompts,
               dec_tokens=dec)
    want = {}
    pols = _policies(JaxPolicy, cfg.n_heads)
    for mode in MODES:
        want[f"fwd_{mode}"] = np.asarray(jax_forward(
            params, rp, {"tokens": jnp.asarray(tokens)}, jcfg, jspec,
            mode=mode, policy=pols[mode])[0])
    if case == "main":
        lg, jc = jax_prefill(params, rp, {"tokens": jnp.asarray(
            tokens[:, :PREFILL_LEN])}, jcfg, jspec, mode="infer",
            max_cache_len=CACHE_LEN, policy=pols["infer"])
        want["prefill"] = np.asarray(lg)
        t = np.full((2,), PREFILL_LEN, np.int32)
        for i in range(DECODE_STEPS):
            lg, jc = jax_decode_step(params, rp, jnp.asarray(dec[i]), jc,
                                     jnp.asarray(t + i), jcfg, jspec,
                                     mode="infer", policy=pols["infer"])
            want[f"decode{i}"] = np.asarray(lg)
        want["caches"] = jax.tree.map(np.asarray, jc)
    jeng = JaxEngine(params, rp, jcfg, jspec, mode="infer",
                     batch_size=BATCH, max_seq=MAX_SEQ)
    want["staggered"] = _staggered(jeng, JaxRequest, prompts, BUDGETS)
    yield want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """JAX's one-device results and both ranks' results from one spawned
    gloo group (JAX computes while the ranks run)."""
    d = tmp_path_factory.mktemp("tp")
    jax_side = {case: _jax_case(case) for case in CASES}
    inputs = {case: next(g) for case, g in jax_side.items()}
    torch.save(inputs, d / "in.pt")
    ranks = mp.start_processes(_rank, args=(_free_port(), str(d)),
                               nprocs=M, join=False, start_method="spawn")
    want = {case: next(g) for case, g in jax_side.items()}   # meanwhile
    while not ranks.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(M)]
    return dict(inputs=inputs, want=want, ranks=ranks)


# -------------------------------- the tests ---------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(tp, case, mode):
    got = [r[case][f"fwd_{mode}"] for r in tp["ranks"]]
    np.testing.assert_array_equal(got[0], got[1])     # gathered, whole rows
    np.testing.assert_allclose(got[0], tp["want"][case][f"fwd_{mode}"],
                               **TOL)


def test_prefill_decode_logits_and_cache_slices_match_jax(tp):
    """Prefill logits, three decode steps' logits, and each rank's ring
    cache: its kv-heads of JAX's cache (mixed per-row budgets)."""
    want = tp["want"]["main"]
    cfg = tp["inputs"]["main"]["cfg"]
    for name in ["prefill"] + [f"decode{i}" for i in range(DECODE_STEPS)]:
        for r in tp["ranks"]:
            np.testing.assert_allclose(r["main"][name], want[name], **TOL)
    for rank, r in enumerate(tp["ranks"]):
        mesh = Mesh({"data": 1, "model": M}, rank=rank)
        jc = caches_from_numpy(want["caches"], cfg, device="cpu", mesh=mesh)
        for got, layer in zip(r["main"]["caches"], jc["layers"]):
            assert got["k"].shape[2] == cfg.n_kv_heads // M
            for name in ("k", "v"):
                np.testing.assert_allclose(got[name],
                                           layer["attn"][name].numpy(), **TOL)
            for name in ("valid", "pos"):
                np.testing.assert_array_equal(got[name],
                                              layer["attn"][name].numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_engine_tokens_match_jax(tp, case):
    """The staggered mixed-budget ring engine: the same greedy tokens on
    both ranks and as JAX's one-device engine; routing decisions clear
    their thresholds by more than 1e-4."""
    for r in tp["ranks"]:
        assert r[case]["staggered"] == tp["want"][case]["staggered"]
        assert r[case]["margin"] > 1e-4


def test_budget_one_is_the_teacher_and_staggered_is_solo(tp):
    for r in tp["ranks"]:
        got = r["main"]
        for i, b in enumerate(BUDGETS):
            if b in (None, 1.0):
                assert got["staggered"][i] == got["teacher"][i]
        assert any(got["staggered"][i] != got["teacher"][i]
                   for i, b in enumerate(BUDGETS) if b is not None and b < 1)
        for i in SOLO:
            assert got["solo"][i] == got["staggered"][i]


def test_every_rank_builds_the_same_plan(tp):
    """Train mode plans every block once; under ``Mesh(debug=True)`` each
    plan's indices and counts were all-gathered and found equal."""
    cfg = tp["inputs"]["main"]["cfg"]
    for r in tp["ranks"]:
        assert r["main"]["plans_checked"] >= cfg.n_layers


def test_rank_launch_shapes_costs_and_geometry(tp):
    """What each rank hands the kernels: q (B, S, H/M, Dh) over K/M
    kv-heads in flash, (B, 1, H/M, Dh) in ring decode, (D, F/M) weight
    columns in the dense and routed MLP; each call's ``kernel_cost`` and
    launch geometry computed at those shapes."""
    cfg = tp["inputs"]["main"]["cfg"]
    H, K, Dh = cfg.n_heads // M, cfg.n_kv_heads // M, cfg.d_head
    D, F = cfg.d_model, cfg.d_ff // M
    for r in tp["ranks"]:
        assert r["main"]["wq"] == (D, H, Dh)
        assert r["main"]["embed"] == (cfg.padded_vocab // M, D)
        seen = {}
        for name, shapes, cost, geo in r["main"]["calls"]:
            seen.setdefault(name, set()).add(
                tuple(sorted((k, v) for k, v in shapes.items()
                             if k in ("q", "k", "wi", "wo"))))
            assert cost is not None and cost[0] > 0
            assert geo["launches"]
        assert set(seen) == {"flash_attention", "decode_attention",
                             "fused_mlp", "fused_mlp_routed"}
        assert {dict(s)["q"][1:] for s in seen["decode_attention"]} == {
            (1, H, Dh)}
        assert {dict(s)["q"][0] for s in seen["decode_attention"]} == {2}
        assert {(dict(s)["q"][2:], dict(s)["k"][2:])
                for s in seen["flash_attention"]} == {((H, Dh), (K, Dh))}
        for name in ("fused_mlp", "fused_mlp_routed"):
            assert {(dict(s)["wi"], dict(s)["wo"]) for s in seen[name]} == {
                ((D, F), (F, D))}


def test_one_decode_signature_at_every_budget(tp):
    """Under a mesh the engine runs eagerly; ``compile_counts()`` means
    that the decode step's launch signatures stay the same across
    budgets, slots and sampling settings: the kernel calls of the
    staggered mixed-budget run's decode steps (their names and operand
    shapes, ``ops.call_signature``) are those of one request served alone
    at each budget, and each ring decode call hands the kernel q at
    (B, 1, H/M, Dh)."""
    for r in tp["ranks"]:
        for case in CASES:
            sigs = r[case]["decode_signatures"]
            assert set(sigs) == {"staggered", *SIG_BUDGETS}
            for b in SIG_BUDGETS:
                assert sigs[b] == sigs["staggered"], (case, b)
            cfg = tp["inputs"][case]["cfg"]
            q = {dict(sg[1:])["q"][0] for sg in sigs["staggered"]
                 if sg[0] == "decode_attention"}
            assert q == {(BATCH, 1, cfg.n_heads_p // M, cfg.d_head)}
            assert r[case]["compiles"] == {"prefill": 0, "decode": 1}


def test_padded_heads_match_jax_on_one_process(tp):
    """Padded q-heads on one process: the pad heads' weights zero, each
    q-head reading kv-head min(h // (H/K), K - 1) as in JAX."""
    c, want = tp["inputs"]["padded"], tp["want"]["padded"]
    cfg, spec = c["cfg"], c["spec"]
    assert cfg.n_heads_p == 8 != cfg.n_heads
    params, rp = params_from_numpy(c["flat"], cfg, spec, device="cpu")
    assert params["layers"][0]["attn"]["wq"].shape[1] == 8
    pols = _policies(ElasticPolicy, cfg.n_heads)
    for mode in MODES:
        got = forward(params, rp, {"tokens": torch.from_numpy(c["tokens"])},
                      cfg, spec, mode=mode, policy=pols[mode])[0]
        np.testing.assert_allclose(got.detach().numpy(), want[f"fwd_{mode}"],
                                   **TOL)
    eng = _engine(params, rp, cfg, spec, None)
    assert _staggered(eng, GenRequest, c["prompts"], BUDGETS) == \
        want["staggered"]


def test_mesh_engine_refusals(tp):
    """What a later part of item 11 brings raises, naming its part; a data
    axis and the paged layout build (tests/test_torch_dp.py serves them);
    a live re-mesh needs a mesh built over a process world."""
    c = tp["inputs"]["main"]
    cfg, spec = c["cfg"], c["spec"]
    params, rp = params_from_numpy(c["flat"], cfg, spec, device="cpu")
    mesh = abstract_mesh((1, M), ("data", "model"))
    mk = lambda p=params, **kw: ServingEngine(p, rp, cfg, spec, batch_size=2,
                                              max_seq=MAX_SEQ, device="cpu",
                                              **kw)
    for kw, what in (
            (dict(mesh=mesh, mode="train"), "part 4, training on a mesh"),
            (dict(mesh=mesh, weight_dtype="int8"), "part 4.*int8"),
            (dict(mesh=mesh, cuda_graphs=True), "part 6, graphed decode")):
        with pytest.raises(NotImplementedError, match=f"item 11.*{what}"):
            mk(**kw)
    with pytest.raises(ValueError, match="shard"):
        mk(mesh=mesh)            # a whole tree: the engine takes a shard
    eng = mk(SH.shard_params(params, mesh), mesh=mesh)
    assert eng.params["layers"][0]["attn"]["wq"].shape[1] == cfg.n_heads // M
    assert eng.scheduler.n_replicas == 1
    dp = abstract_mesh((2, M), ("data", "model"))
    for kw in (dict(mesh=dp), dict(mesh=dp, kv_layout="paged"),
               dict(mesh=mesh, kv_layout="paged")):
        e = mk(SH.shard_params(params, kw["mesh"]), **kw)
        assert e.scheduler.n_replicas == kw["mesh"].shape["data"]
    with pytest.raises(RuntimeError, match="abstract mesh"):
        eng.reshard(mesh)        # no process group to gather over
    with pytest.raises(TypeError, match="runtime.mesh.Mesh"):
        eng.reshard(object())
    odd = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3)
    with pytest.raises(NotImplementedError, match="padded heads"):
        with mesh:
            check_kernel_ok(odd)
