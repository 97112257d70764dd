"""Serving on a (data=2, model=2) mesh against the JAX package's one-device
engine with two replicas.

One group of four gloo ranks on CPU processes, spawned once per module by
a fixture that runs every case and returns its results: rank (d, m) holds
model shard m and replica d's two slots of the ring cache, or replica d's
half of the page pool, at its kv-heads. Its reference is JAX's one-device
engine on the same weights (``kernel_backend="ref"``) built with
``n_replicas=2`` (``src/repro/training/serve.py:210``), which places
requests on the replicas as a (2, M) mesh does; JAX's own mesh engine is
not the reference, since its test fails on this host.

Held, on smoke Qwen2 (2 layers, 4 q-heads on 2 kv-heads, f32) with token
routing, head top-k and LoRA: the ring and the paged engines' greedy
tokens of a staggered mixed-budget run and each handle's replica against
JAX, on every rank; ``paged_stats`` against JAX; one paged ``decode_step``
and one ``prefill_chunk_step`` per replica on a filled pool carried from
JAX (``interop.caches_from_numpy(mesh=)``, global page ids rebased per
rank) against JAX's on the whole pool, logits within 1e-5; each rank's
paged-decode kernel calls at (B/2, 1, H/2, Dh) over N/2 pages and local
page ids (``ops.recording``, JAX's ``seen`` at
tests/test_sharding_multidev.py:213) with their ``kernel_cost``; a live
re-mesh (2, 2) -> (1, 2) -> None mid-run with JAX's tokens and
``compile_counts()`` prefill 0 / decode 1 after it, as JAX asserts
(tests/test_sharding_multidev.py:163); a second re-mesh after ranks
left, (1, 2) -> (2, 1) through ``remesh_fallback``; ``remesh_fallback``
skipping a shape the world cannot hold and landing on (1, 2); a first
token that ends its request freeing its pages for the same step's next
admission, with JAX's counts and ``paged_stats``; the paged engine's
refusal to re-mesh; the refusals that remain (train mode, int8 weights,
graphs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import ElasticPolicy  # noqa: E402
from repro_torch.interop import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.launch.mesh import destroy, make_mesh, remesh  # noqa: E402
from repro_torch.models import decode_step, prefill_chunk_step  # noqa: E402
from repro_torch.runtime import fault_tolerance as TF  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.runtime.mesh import abstract_mesh  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from tests.test_torch_tp import SPEC_KW, _cfg, _free_port, _Margins  # noqa: E402

D, M = 2, 2
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, MAX_SEQ, PS, NEW = 4, 48, 8, 6
LENS = (10, 19, 8, 16, 13)
BUDGETS = (1.0, 0.5, None, 0.75, 0.5)
N_POOL = 12                  # the filled pool: 6 pages a replica
PAGED_KW = dict(kv_layout="paged", page_size=PS)
TIMEOUT_S = 240              # a collective one rank never joins raises


def _staggered(engine, make_req, prompts):
    """Two requests, two steps, the rest: admissions land mid-decode."""
    handles = [engine.submit(make_req(p, NEW, budget=b))
               for p, b in zip(prompts[:2], BUDGETS[:2])]
    for _ in range(2):
        engine.step()
    handles += [engine.submit(make_req(p, NEW, budget=b))
                for p, b in zip(prompts[2:], BUDGETS[2:])]
    while not all(h.done for h in handles):
        assert engine.step() > 0
    return ([[int(t) for t in h.output] for h in handles],
            [engine.scheduler.replica_of(h.slot) for h in handles])


def _fork_and_preempt(make_engine, make_req, prompts) -> dict:
    """A fork on replica 1 after three steps, and three requests on a
    pool of 5 pages a replica (4 usable) where replica 0's two fill it at
    admission and the 16-token prompt's first decode needs a fifth (the
    later one is preempted and resumes): every request's tokens and
    replica, the preemptions and the drained pools."""
    eng = make_engine(PAGED_KW)
    hs = [eng.submit(make_req(prompts[i], NEW, budget=b))
          for i, b in ((0, 1.0), (1, 0.5))]
    for _ in range(3):
        eng.step()
    hs.append(eng.fork(hs[1]))
    while not all(h.done for h in hs):
        assert eng.step() > 0
    out = {"fork": [[int(t) for t in h.output] for h in hs],
           "fork_replicas": [eng.scheduler.replica_of(h.slot) for h in hs],
           "fork_allocated": eng.paged_stats()["allocated"]}
    eng = make_engine(dict(PAGED_KW, n_pages=10))
    hs = [eng.submit(make_req(prompts[i], NEW, budget=1.0))
          for i in (3, 4, 0)]
    while not all(h.done for h in hs):
        assert eng.step() > 0
    out.update(preempt=[[int(t) for t in h.output] for h in hs],
               preempt_replicas=[eng.scheduler.replica_of(h.slot)
                                 for h in hs],
               n_preempted=getattr(eng, "n_preempted", None),  # port only
               preempt_allocated=eng.paged_stats()["allocated"])
    return out


def _first_token_frees_pages(make_engine, make_req, prompts) -> dict:
    """Three admissions of one step on a pool of 5 pages a replica (4
    usable): a 3-page prompt with one new token on replica 0, a request on
    replica 1, and a 2-page prompt on replica 0 that fits only once the
    first one's first token has ended it and freed its pages (JAX appends
    each first token before the next admission allocates). Each request's
    token count and the pool's stats after that step; then every
    request's tokens and replica."""
    eng = make_engine(dict(PAGED_KW, n_pages=10))
    hs = [eng.submit(make_req(prompts[i], n, budget=1.0))
          for i, n in ((1, 1), (0, NEW), (4, NEW))]
    eng.step()
    out = {"first_step": [len(h.output) for h in hs],
           "first_stats": eng.paged_stats()}
    while not all(h.done for h in hs):
        assert eng.step() > 0
    out.update(tokens=[[int(t) for t in h.output] for h in hs],
               replicas=[eng.scheduler.replica_of(h.slot) for h in hs])
    return {"first_token": out}


def _pool_case():
    """A decode (four slots, two a replica: mid-page, page boundary, one
    inactive) and a final chunk per replica, each replica's rows holding
    pages of its own range of the 12-page pool (trash pages 5 and 11)."""
    table = np.full((BATCH, 4), -1, np.int32)
    table[0, :2] = [3, 1]                     # t = 12: mid-page 1
    table[2, :3] = [6, 9, 7]                  # t = 16: first lane of page 2
    table[3, :2] = [10, 8]                    # t = 9
    t = np.asarray([12, 40, 16, 9], np.int32)  # slot 1: inactive
    trash = np.asarray([5, 5, 11, 11], np.int32)
    rows = [np.asarray([2, 0, 4, -1, -1, -1], np.int32),
            np.asarray([8, 6, 10, -1, -1, -1], np.int32)]
    return dict(table=table, t=t, trash=trash, rows=rows, write=[4, 10],
                pos0=16, plen=21)


# ------------------------------- the ranks ----------------------------------

def _engine(params, rp, c, mesh, **kw):
    return ServingEngine(params, rp, c["cfg"], c["spec"], batch_size=BATCH,
                         max_seq=MAX_SEQ, device="cpu", mesh=mesh,
                         **{"mode": "infer", **kw})


def _pool_steps(mesh, c, params, rp) -> dict:
    """The model's paged paths under the mesh on the rank's slice of a
    filled JAX pool: the decode of its replica's rows, the chunk of its
    replica's row; logits and the pool slice afterwards."""
    cfg, spec, p = c["cfg"], c["spec"], c["pool"]
    d = mesh.data_rank
    lo = d * (BATCH // D)
    sl = slice(lo, lo + BATCH // D)
    out = {}
    local = ElasticPolicy.stack([ElasticPolicy.uniform(
        float(b), n_heads=cfg.n_heads) for b in c["pool_budgets"][sl]])
    with mesh, OPS.recording() as calls:
        caches = caches_from_numpy(c["pool_tree"], cfg, device="cpu",
                                   mesh=mesh)
        lg, caches = decode_step(
            params, rp, torch.from_numpy(c["pool_tok"][sl]), caches,
            torch.from_numpy(p["t"][sl]), cfg, spec, mode="infer",
            policy=local, table=torch.from_numpy(p["table"][sl]),
            trash=torch.from_numpy(p["trash"][sl]))
        out["decode_logits"] = lg.numpy()
        lg, caches = prefill_chunk_step(
            params, rp, torch.from_numpy(c["chunk_tok"]), caches,
            p["write"][d], torch.from_numpy(p["rows"][d]), p["pos0"],
            p["plen"], cfg, spec, mode="infer",
            policy=ElasticPolicy.uniform(0.5, n_heads=cfg.n_heads))
        out["chunk_logits"] = lg.numpy()
    out["pool"] = [{k: v.numpy() for k, v in la["attn"].items()}
                   for la in caches["layers"]]
    out["pool_calls"] = _calls(calls)
    return out


def _calls(calls) -> list:
    return [(cl.name, {k: (tuple(v.shape), int(v.max()))
                       if k == "table" else tuple(v.shape)
                       for k, v in cl.args.items() if torch.is_tensor(v)},
             cl.cost) for cl in calls
            if cl.name == "paged_decode_attention"]


def _rank_cases(mesh, c) -> dict:
    params, rp = params_from_numpy(c["flat"], c["cfg"], c["spec"],
                                   device="cpu", mesh=mesh)
    req = lambda i: GenRequest(c["prompts"][i], NEW, budget=BUDGETS[i])
    out = {}
    margins = _Margins()
    try:
        out["ring"] = _staggered(_engine(params, rp, c, mesh), GenRequest,
                                 c["prompts"])
        paged = _engine(params, rp, c, mesh, kv_layout="paged",
                        page_size=PS)
        with OPS.recording() as calls:
            out["paged"] = _staggered(paged, GenRequest, c["prompts"])
        out["paged_calls"] = _calls(calls)
        out["paged_stats"] = paged.paged_stats()
        out["compiles"] = [paged.compile_counts()]
        try:
            paged.reshard(None)
        except NotImplementedError as e:
            out["paged_refusal"] = str(e)
    finally:
        out["margin"] = margins.close()
    out.update(_pool_steps(mesh, c, params, rp))
    out.update(_fork_and_preempt(lambda kw: _engine(params, rp, c, mesh,
                                                    **kw),
                                 GenRequest, c["prompts"]))
    out.update(_first_token_frees_pages(
        lambda kw: _engine(params, rp, c, mesh, **kw), GenRequest,
        c["prompts"]))

    # a live re-mesh (2, 2) -> (1, 2) -> None, every request in flight
    eng = _engine(params, rp, c, mesh)
    hs = [eng.submit(req(i)) for i in range(BATCH)]
    eng.step()
    eng.step()
    eng.reshard(remesh(mesh, (1, M)))
    out["left_at"] = None
    if eng.left:
        out["left_at"] = "(1, 2)"
    else:
        out["n_replicas"] = eng.scheduler.n_replicas
        eng.step()
        eng.step()
        out["compiles"].append(eng.compile_counts())
        eng.reshard(None)
        if eng.left:
            out["left_at"] = "None"
        else:
            while eng.has_work:
                eng.step()
            out["compiles"].append(eng.compile_counts())
            out["remesh"] = [[int(t) for t in h.output] for h in hs]

    # remesh_fallback: a shape past the world's four ranks, then (1, 2)
    eng = _engine(params, rp, c, mesh)
    hs = [eng.submit(req(i)) for i in range(BATCH)]
    eng.step()
    shapes = [(4, 2), (1, 2)]
    new = TF.remesh_fallback(eng, shapes)
    out["fallback_mesh"] = (dict(new.shape), shapes, eng.left)
    if not eng.left:
        while eng.has_work:
            eng.step()
        out["fallback"] = [[int(t) for t in h.output] for h in hs]

    # last, so that the ranks that leave stop as a server's would: (2, 2)
    # -> (1, 2), which ranks 2 and 3 leave; then (1, 2) -> (2, 1) through
    # remesh_fallback without them; then None. No re-mesh makes a group.
    made, real = [], dist.new_group
    dist.new_group = lambda *a, **k: made.append(a) or real(*a, **k)
    out["world_groups"] = len(mesh.groups)
    eng = _engine(params, rp, c, mesh)
    hs = [eng.submit(req(i)) for i in range(BATCH)]
    eng.step()
    eng.reshard(remesh(mesh, (1, M)))
    out["twice_left"] = "(1, 2)" if eng.left else None
    if not eng.left:
        eng.step()
        new = TF.remesh_fallback(eng, [(2, 1)])
        out["twice_mesh"] = (dict(new.shape), eng.scheduler.n_replicas)
        eng.step()
        out["twice_compiles"] = eng.compile_counts()
        eng.reshard(None)
        if eng.left:
            out["twice_left"] = "None"
        else:
            while eng.has_work:
                eng.step()
            out["twice"] = [[int(t) for t in h.output] for h in hs]
    dist.new_group = real
    out["twice_new_groups"] = len(made)
    return out


def _rank(rank: int, port: int, d: str) -> None:
    torch.set_num_threads(1)
    c = torch.load(f"{d}/in.pt", weights_only=False)
    mesh = make_mesh((D, M), ("data", "model"), backend="gloo", rank=rank,
                     init_method=f"tcp://localhost:{port}",
                     timeout=TIMEOUT_S)
    try:
        out = _rank_cases(mesh, c)
    finally:
        destroy(mesh)
    torch.save(out, f"{d}/rank{rank}.pt")


# ------------------------------ JAX's side ----------------------------------

def _jax_side():
    """The JAX case and the inputs the ranks take; then, as a generator's
    second step, JAX's one-device results with two replicas."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import _flatten, _unflatten_into
    from repro.configs import get_config as jax_get_config
    from repro.core.policy import ElasticPolicy as JaxPolicy
    from repro.core.policy import ElasticSpec as JaxSpec
    from repro.models import decode_step as jax_decode_step
    from repro.models import model_init, router_init
    from repro.models.model import paged_cache_init
    from repro.models.model import prefill_chunk_step as jax_chunk
    from repro.training import GenRequest as JaxRequest
    from repro.training import ServingEngine as JaxEngine
    from repro_torch.core.policy import ElasticSpec

    jcfg, cfg = _cfg(jax_get_config, "main"), _cfg(get_config, "main")
    jspec = JaxSpec(**SPEC_KW, kernel_backend="ref")
    key = jax.random.PRNGKey(11)
    params = model_init(key, jcfg, jspec)
    rp = router_init(jax.random.fold_in(key, 1), jcfg, jspec)
    rng = np.random.default_rng(11)
    rflat = {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.05
                 if "['lora']" in k and k.endswith("['b']") else v)
             for k, v in _flatten(rp).items()}
    rp = jax.tree.map(jnp.asarray, _unflatten_into(rp, rflat))
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    prompts[3][:PS] = prompts[1][:PS]           # a shared first page
    tree = jax.tree.map(np.asarray, paged_cache_init(jcfg, N_POOL, PS))
    tree = jax.tree.map(lambda a: (rng.random(a.shape) < 0.8) if a.dtype
                        == bool else rng.standard_normal(a.shape).astype(
                            a.dtype), tree)
    pool = _pool_case()
    pool_tok = rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    chunk_tok = np.zeros((1, PS), np.int32)
    chunk_tok[0, :pool["plen"] - pool["pos0"]] = rng.integers(
        0, cfg.vocab_size, pool["plen"] - pool["pos0"])
    pool_budgets = np.asarray([0.5, 1.0, 0.75, 0.5])
    yield dict(flat=_flatten({"params": params, "routers": rp}), cfg=cfg,
               spec=ElasticSpec(**SPEC_KW), prompts=prompts, pool=pool,
               pool_tree=tree, pool_tok=pool_tok, chunk_tok=chunk_tok,
               pool_budgets=pool_budgets)

    mk = lambda **kw: JaxEngine(params, rp, jcfg, jspec, mode="infer",
                                batch_size=BATCH, max_seq=MAX_SEQ,
                                n_replicas=D, **kw)
    want = {"ring": _staggered(mk(), JaxRequest, prompts)}
    jpaged = mk(kv_layout="paged", page_size=PS)
    want["paged"] = _staggered(jpaged, JaxRequest, prompts)
    want["paged_stats"] = jpaged.paged_stats()
    want.update(_fork_and_preempt(lambda kw: mk(**kw), JaxRequest, prompts))
    want.update(_first_token_frees_pages(lambda kw: mk(**kw), JaxRequest,
                                         prompts))
    solo = mk()
    want["solo"] = [[int(t) for t in solo.generate([JaxRequest(
        prompts[i], NEW, budget=BUDGETS[i])])[0]] for i in range(BATCH)]
    jc = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_decode_step(
        params, rp, jnp.asarray(pool_tok), jc, jnp.asarray(pool["t"]),
        jcfg, jspec, mode="infer",
        policy=JaxPolicy.stack([JaxPolicy.uniform(float(b),
                                                  n_heads=cfg.n_heads)
                                for b in pool_budgets]),
        table=jnp.asarray(pool["table"]), trash=jnp.asarray(pool["trash"]))
    want["decode_logits"] = np.asarray(jl)
    want["chunk_logits"], want["pool"] = [], []
    for d in range(D):
        cl, cc = jax_chunk(
            params, rp, jnp.asarray(chunk_tok), jc, jnp.int32(pool["write"][d]),
            jnp.asarray(pool["rows"][d]), jnp.int32(pool["pos0"]),
            jnp.int32(pool["plen"]), jcfg, jspec, mode="infer",
            policy=JaxPolicy.uniform(0.5, n_heads=cfg.n_heads))
        want["chunk_logits"].append(np.asarray(cl))
        want["pool"].append(jax.tree.map(np.asarray, cc))
    yield want


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """JAX's one-device results and the four ranks' results from one
    spawned gloo group (JAX computes while the ranks run)."""
    d = tmp_path_factory.mktemp("dp")
    jax_side = _jax_side()
    inputs = next(jax_side)
    torch.save(inputs, d / "in.pt")
    ranks = mp.start_processes(_rank, args=(_free_port(), str(d)),
                               nprocs=D * M, join=False,
                               start_method="spawn")
    want = next(jax_side)                                 # meanwhile
    while not ranks.join(timeout=TIMEOUT_S + 60):
        pass
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(D * M)]
    return dict(inputs=inputs, want=want, ranks=ranks)


# -------------------------------- the tests ---------------------------------

@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_engine_tokens_and_replicas_match_jax(dp, layout):
    """The staggered mixed-budget run on the (2, 2) mesh: JAX's tokens and
    JAX's replica for every request, on every rank; admissions land on
    both replicas; routing decisions clear their thresholds by 1e-4."""
    tokens, replicas = dp["want"][layout]
    assert set(replicas) == {0, 1}
    for r in dp["ranks"]:
        assert r[layout] == (tokens, replicas)
        assert r["margin"] > 1e-4


def test_paged_stats_match_jax(dp):
    """The pool's bookkeeping is host state every rank holds whole: after
    the run (a shared first page between two requests on one replica) the
    stats equal JAX's, every page back on the freelists."""
    want = dp["want"]["paged_stats"]
    for r in dp["ranks"]:
        assert r["paged_stats"] == want
        assert want["allocated"] == 0 and want["free"] == want["usable"]


def test_paged_steps_on_a_filled_pool_match_jax(dp):
    """One paged decode of the rank's replica's two slots (global page
    ids, the inactive slot writing its replica's trash page) and one final
    chunk of its replica's row, against JAX on the whole pool: logits
    within 1e-5 and the rank's slice of every layer's pool."""
    want, cfg = dp["want"], dp["inputs"]["cfg"]
    for rank, r in enumerate(dp["ranks"]):
        d, m = divmod(rank, M)
        lo = d * (BATCH // D)
        np.testing.assert_allclose(r["decode_logits"],
                                   want["decode_logits"][lo:lo + BATCH // D],
                                   **TOL)
        np.testing.assert_allclose(r["chunk_logits"],
                                   want["chunk_logits"][d], **TOL)
        mesh = abstract_mesh((D, M), ("data", "model"))
        mesh.rank = rank
        jc = caches_from_numpy(want["pool"][d], cfg, device="cpu", mesh=mesh)
        for got, layer in zip(r["pool"], jc["layers"]):
            assert got["kp"].shape == (N_POOL // D, PS,
                                       cfg.n_kv_heads // M, cfg.d_head)
            for name in ("kp", "vp"):
                np.testing.assert_allclose(got[name],
                                           layer["attn"][name].numpy(), **TOL)
            np.testing.assert_array_equal(got["pvalid"],
                                          layer["attn"]["pvalid"].numpy())


def test_rank_paged_decode_calls_are_local(dp):
    """Each rank's ``paged_decode_attention`` kernel calls: decode at
    (B/2, 1, H/2, Dh) and chunks at (page_size, 1, H/2, Dh), over N/2 pages
    of K/2 kv-heads, through tables rebased to local ids; each call's
    ``kernel_cost`` is the one ``ops.kernel_cost`` gives those shapes."""
    cfg = dp["inputs"]["cfg"]
    H, K, Dh = cfg.n_heads // M, cfg.n_kv_heads // M, cfg.d_head
    pps = -(-MAX_SEQ // PS)
    n_local = (BATCH * pps + D) // D
    for r in dp["ranks"]:
        for calls, pool in ((r["paged_calls"], n_local),
                            (r["pool_calls"], N_POOL // D)):
            qs = {sh["q"] for _, sh, _ in calls}
            assert qs == {(BATCH // D, 1, H, Dh), (PS, 1, H, Dh)}, qs
            for _, sh, cost in calls:
                assert sh["kp"] == (pool, PS, K, Dh)
                assert sh["table"][1] < pool
                assert cost is not None and cost[0] > 0 and cost[1] > 0
    q = torch.zeros(BATCH // D, 1, H, Dh)
    kp = torch.zeros(N_POOL // D, PS, K, Dh)
    table = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    t = torch.tensor([12, 3], dtype=torch.int32)
    pv = torch.ones(N_POOL // D, PS, dtype=torch.bool)
    cost = OPS.kernel_cost("paged_decode_attention", q, kp, kp, table, t, pv)
    assert cost[0] == 4 * Dh * H * (13 + 4)


def test_live_remesh_keeps_every_token(dp):
    """(2, 2) -> (1, 2) after two steps with every request in flight, then
    (1, 2) -> None: ranks 2 and 3 leave at the first, rank 1 at the
    second; rank 0 finishes every request with JAX's solo tokens, the
    scheduler on one replica, ``compile_counts()`` prefill 0 / decode 1
    after each re-mesh."""
    ranks = dp["ranks"]
    assert [r["left_at"] for r in ranks] == [None, "None", "(1, 2)",
                                            "(1, 2)"]
    assert ranks[0]["remesh"] == dp["want"]["solo"]
    assert ranks[0]["n_replicas"] == ranks[1]["n_replicas"] == 1
    want = {"prefill": 0, "decode": 1}
    assert ranks[0]["compiles"] == [{"prefill": 1, "decode": 1}, want, want]
    assert ranks[1]["compiles"] == [{"prefill": 1, "decode": 1}, want]


def test_remesh_twice_after_ranks_left(dp):
    """(2, 2) -> (1, 2), which ranks 2 and 3 leave, then (1, 2) -> (2, 1)
    through ``remesh_fallback`` on ranks 0 and 1 alone (the world's groups
    were made once, by ``make_mesh``, with its timeout: no re-mesh makes
    a group, so none waits for the ranks that left), then None: two
    replicas on (2, 1), ``compile_counts()`` prefill 0 / decode 1 after
    the second re-mesh, JAX's solo tokens."""
    ranks = dp["ranks"]
    for r in ranks:                # 10 distinct rank sets in a 4-rank world
        assert (r["world_groups"], r["twice_new_groups"]) == (10, 0)
    assert [r["twice_left"] for r in ranks] == [None, "None", "(1, 2)",
                                               "(1, 2)"]
    for r in ranks[:2]:
        assert r["twice_mesh"] == ({"data": 2, "model": 1}, 2)
        assert r["twice_compiles"] == {"prefill": 0, "decode": 1}
    assert ranks[0]["twice"] == dp["want"]["solo"]


def test_first_token_frees_pages_for_the_next_admission(dp):
    """A first token that ends its request (max_new_tokens=1) frees its
    pages before the same step's next admission on its replica allocates,
    as in JAX's engine: after that step every request's token count and
    the pool's stats equal JAX's, and so do the tokens and replicas."""
    want = dp["want"]["first_token"]
    assert want["first_step"][2] > 0 and want["replicas"][::2] == [0, 0]
    for r in dp["ranks"]:
        assert r["first_token"] == want


def test_remesh_fallback_lands_on_a_real_shape(dp):
    """``remesh_fallback`` skips (4, 2) (more ranks than the world) and
    re-meshes onto (1, 2); the requests finish with JAX's tokens."""
    for rank, r in enumerate(dp["ranks"]):
        shape, left_shapes, left = r["fallback_mesh"]
        assert shape == {"data": 1, "model": M} and left_shapes == []
        assert left == (rank >= M)
    for r in dp["ranks"][:M]:
        assert r["fallback"] == dp["want"]["solo"]


def test_fork_and_preemption_stay_within_a_replica(dp):
    """A copy-on-write fork on replica 1 (the page copy on its ranks only)
    and a preemption under page pressure on replica 0 (a 10-page pool, 5
    a replica): JAX's tokens and replicas on every rank, the child beside
    its parent, the same preemptions on every rank, the pools drained."""
    want = dp["want"]
    assert want["fork_replicas"] == [0, 1, 1]
    assert want["preempt_replicas"][0] == want["preempt_replicas"][2]
    for r in dp["ranks"]:
        for k in ("fork", "fork_replicas", "preempt", "preempt_replicas"):
            assert r[k] == want[k], k
        assert r["n_preempted"] == dp["ranks"][0]["n_preempted"] >= 1
        assert r["fork_allocated"] == r["preempt_allocated"] == 0


def test_refusals_on_a_data_axis(dp):
    """A paged engine refuses to re-mesh with JAX's message; train mode,
    int8 weights and graphs on a mesh name their part of item 11; a batch
    the data axis does not divide raises."""
    for r in dp["ranks"]:
        assert "page ids are replica-local" in r["paged_refusal"]
    c = dp["inputs"]
    mesh = abstract_mesh((D, M), ("data", "model"))
    params, rp = params_from_numpy(c["flat"], c["cfg"], c["spec"],
                                   device="cpu", mesh=mesh)
    for kw, what in ((dict(mode="train"), "part 4, training"),
                     (dict(weight_dtype="int8"), "part 4.*int8"),
                     (dict(cuda_graphs=True), "part 6, graphed decode")):
        with pytest.raises(NotImplementedError, match=f"item 11.*{what}"):
            _engine(params, rp, c, mesh, **kw)
    with pytest.raises(ValueError, match="multiple of the replica count"):
        ServingEngine(params, rp, c["cfg"], c["spec"], batch_size=3,
                      max_seq=MAX_SEQ, device="cpu", mesh=mesh)
    eng = _engine(params, rp, c, mesh)
    assert (eng.scheduler.n_replicas, eng._bl) == (D, BATCH // D)
    assert SH.data_axis_size(mesh) == D
