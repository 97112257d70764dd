"""Serving driver of the port: init a model and routers (random weights,
seeded), run the elastic threshold-routed decode over a stream of requests.

Per-request compute budgets ride on the live ElasticPolicy rows: one
captured decode step serves every budget, mixed budgets in one batch
included. Runs on the CUDA card unless ``--device cpu`` is given.

Closed loop (submit everything, drain):
    python -m repro_torch.launch.serve --arch toy-lm --device cpu \\
        --requests 16 --max-new 32 --budget 0.25,0.5,1.0

Open loop (continuous batching under Poisson arrivals; reports throughput,
per-request latency and slot occupancy):
    python -m repro_torch.launch.serve --arch qwen2-7b --variant full \\
        --requests 8 --batch 4 --prompt-len 256 --max-new 32 \\
        --budget 0.5,0.75,1.0 --arrival-rate 4 --kv-layout paged \\
        --kv-dtype bf16 --weight-dtype bf16

On a (data, model) mesh (D*M ranks spawned with ``torch.multiprocessing``,
each serving its shard of the same weights in lockstep: TP over ``model``,
the slot array split into D replicas the scheduler packs; rank 0 prints
the report, with the per-replica lines in the open loop):
    python -m repro_torch.launch.serve --arch toy-lm --device cpu \
        --mesh 2,2 --backend gloo --requests 8 --max-new 8

A live re-mesh (``--remesh-at N``: after the N-th submission of the open
loop the engine moves onto ``--remesh-to``, or the next
``valid_mesh_shapes`` entry; in-flight requests keep their tokens, the
ranks outside the new shape drain and leave):
    python -m repro_torch.launch.serve --arch toy-lm --device cpu \
        --mesh 2,2 --backend gloo --arrival-rate 8 --requests 8 \
        --remesh-at 4 --remesh-to 1,2

``--backend`` names the collectives' backend: ``gloo`` (CPU ranks, or
ranks that share one card: NCCL refuses two ranks on one device) or
``nccl`` (one card per rank; untested). On the card every rank takes
``cuda:(rank % cards)``. On a mesh the open loop's arrivals are counted
on rank 0's clock and broadcast each iteration, so every rank submits
the same requests at the same step.

This is the JAX package's ``launch/serve.py`` with the same flags and
report lines, and ``--device`` and ``--backend``. A controller on a mesh
is refused: each rank would degrade on its own wall clock and leave the
lockstep.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import socket
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_elastic
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, destroy, make_mesh
from repro_torch.launch.workloads import arrival_times, latency_stats, replay
from repro_torch.models import model_init, router_init
from repro_torch.optim.optimizer import tree_map
from repro_torch.runtime.elastic import valid_mesh_shapes
from repro_torch.runtime.sharding import shard_params
from repro_torch.training import GenRequest, ServingEngine

__all__ = ["open_loop", "latency_stats", "replica_report", "main"]

TIMEOUT_S = 900     # seconds before a collective a rank never joins raises


def _budget_list(s: str):
    try:
        vals = [float(b) for b in s.split(",")]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--budget expects a float or comma list of floats, got {s!r}")
    for v in vals:
        if not 0.0 < v <= 1.0:
            raise argparse.ArgumentTypeError(
                f"budgets must be fractions in (0, 1], got {v}")
    return vals


def _mesh_shape(s: str):
    try:
        d, m = (int(x) for x in s.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a 'data,model' int pair, got {s!r}")
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"mesh axes must be >= 1, got {s!r}")
    return (d, m)


def open_loop(engine, requests, rate: float, seed: int = 0, arrive=None,
              remesh_at=None, remesh_to=None):
    """Submit ``requests`` at Poisson arrival times (``rate`` req/s from
    ``np.random.default_rng(seed)``, or an explicit ``arrive`` schedule in
    seconds) while continuously stepping the engine; returns (handles,
    elapsed_seconds). Each handle's ``t_submit`` is pinned to its
    *scheduled* arrival, so ``latency`` measures arrival -> last token
    (queueing included). The loop is ``workloads.replay`` on the wall
    clock, so the engine must stamp its handles on the wall clock too; on
    a mesh every rank runs it in lockstep.

    ``remesh_at=N`` (a mesh engine): after the N-th submission, re-mesh
    the LIVE engine onto the ``remesh_to`` (data, model) shape; in-flight
    requests keep decoding the same tokens, and a rank outside the new
    shape drains and returns."""
    if remesh_at is not None and getattr(engine, "mesh", None) is None:
        raise ValueError("open_loop(remesh_at=): a live re-mesh moves a "
                         "mesh engine over its process world; build the "
                         "engine on a mesh (--mesh)")
    if getattr(engine, "_clock", time.perf_counter) is not time.perf_counter:
        raise ValueError(
            "open_loop runs on the wall clock (time.perf_counter) and this "
            "engine stamps its handles on an injected clock: use "
            "launch.workloads.replay(engine, reqs, arrive, clock=) instead")
    if arrive is None:
        rng = np.random.default_rng(seed)
        arrive = np.cumsum(rng.exponential(1.0 / rate, len(requests)))
    handles, elapsed, info = replay(engine, requests, arrive,
                                    remesh_at=remesh_at, remesh_to=remesh_to)
    if info.get("remesh") is not None and (engine.mesh is None
                                           or engine.mesh.rank == 0):
        n, secs, active = info["remesh"]
        print(f"[serve] re-meshed live to (data, model)={remesh_to} after "
              f"{n} submissions ({secs:.2f}s, {active} requests in flight)")
    return handles, elapsed


def replica_report(engine, handles) -> str:
    """Per-replica occupancy + mean latency lines for the open-loop report
    (a handle's replica = the data shard its final slot lived on). After a
    live re-mesh the window is "since the re-mesh": the occupancy counters
    restart there, so requests that finished before it are excluded."""
    sched = engine.scheduler
    t0 = engine.remeshed_at
    hs_all = [h for h in handles if h is not None and h.slot is not None
              and (t0 is None or h.t_done is None or h.t_done >= t0)]
    lines = [] if t0 is None else \
        [f"  (per-replica window: since the live re-mesh; "
         f"{len(handles) - len(hs_all)} earlier requests excluded)"]
    for r in range(sched.n_replicas):
        hs = [h for h in hs_all if sched.replica_of(h.slot) == r]
        st = latency_stats(hs)
        lines.append(
            f"  replica {r}: {len(hs)} requests, occupancy "
            f"{sched.replica_occupancy[r]:.0%}, e2e mean {st['mean_ms']:.0f}"
            f" / p50 {st['p50_ms']:.0f} / p95 {st['p95_ms']:.0f} ms, "
            f"ttft p95 {st['ttft_p95_ms']:.0f} ms, "
            f"itl p95 {st['itl_p95_ms']:.1f} ms")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="toy-lm")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mode", default="infer", choices=["infer", "base"])
    ap.add_argument("--kv-layout", default="ring", choices=["ring", "paged"],
                    help="KV cache layout: 'ring' reserves max_seq per slot; "
                         "'paged' serves from a block-paged pool with prefix "
                         "sharing and chunked prefill (one captured chunk "
                         "for any prompt length)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged layout only)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="total physical KV pages (default: ring-equivalent "
                         "memory, i.e. batch * pages-per-full-sequence)")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="KV cache storage dtype; int8 stores per-(token,"
                         "head) scales beside the codes, read by the decode "
                         "kernels")
    ap.add_argument("--weight-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="base weight storage dtype; int8 quantizes per "
                         "output channel at engine init")
    ap.add_argument("--budget", default=None, type=_budget_list,
                    help="per-request compute budget(s) in (0,1]: a float, "
                         "or a comma list assigned round-robin (mixed "
                         "budgets batch together in one decode step)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop mode: Poisson request arrivals at this "
                         "rate (req/s); reports per-request latency and "
                         "slot occupancy on top of throughput")
    ap.add_argument("--trace", default="poisson",
                    choices=["poisson", "bursty", "diurnal"],
                    help="open-loop arrival process (launch/workloads.py): "
                         "'bursty' = 4x burst in the middle 40%% of "
                         "requests, 'diurnal' = sinusoidal rate around "
                         "--arrival-rate")
    ap.add_argument("--depth-routed", action="store_true",
                    help="enable the elastic depth router (per-token whole-"
                         "layer skip): budgets below 1.0 skip full blocks "
                         "per token, decode skips write no KV at that layer")
    ap.add_argument("--controller", action="store_true",
                    help="enable the SLO feedback controller (graceful "
                         "degradation: admission budgets -> in-flight "
                         "budgets -> load shedding -> remesh escalation)")
    ap.add_argument("--slo-p95-ms", type=float, default=None,
                    help="p95 TTFT SLO target in ms for the default class "
                         "(implies --controller; default 500)")
    ap.add_argument("--slo-floor", type=float, default=0.25,
                    help="lowest budget the controller may degrade to")
    ap.add_argument("--flop-budget", type=float, default=None,
                    help="per-step FLOP admission budget in full-budget-row "
                         "units (default: the slots, i.e. slot-limited)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the top-k logits (0 = all)")
    ap.add_argument("--eos", type=int, default=None,
                    help="stop token id (default: config eos_id)")
    ap.add_argument("--mesh", type=_mesh_shape, default=None,
                    help="serve on a 'data,model' mesh (e.g. 2,2): D*M "
                         "ranks, TP over `model`, the slot array split into "
                         "`data` replicas the scheduler packs")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="the collectives' backend of --mesh (gloo: CPU "
                         "ranks or ranks sharing one card; nccl: one card "
                         "per rank)")
    ap.add_argument("--remesh-at", type=int, default=None,
                    help="after this many submissions, re-mesh the LIVE "
                         "engine (open loop on a mesh; in-flight requests "
                         "resume with identical tokens)")
    ap.add_argument("--remesh-to", type=_mesh_shape, default=None,
                    help="target 'data,model' shape for --remesh-at "
                         "(default: the next valid_mesh_shapes entry)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mesh is not None and args.batch % args.mesh[0]:
        ap.error(f"--batch {args.batch} must be a multiple of the mesh data "
                 f"axis {args.mesh[0]}")
    if args.remesh_at is not None or args.remesh_to is not None:
        if args.mesh is None or args.arrival_rate is None \
                or args.remesh_at is None:
            ap.error("--remesh-at requires --mesh and --arrival-rate "
                     "(--remesh-to names its shape)")
        if args.remesh_to is None:
            cands = [s for s in valid_mesh_shapes(math.prod(args.mesh),
                                                  args.mesh[1])
                     if s != tuple(args.mesh) and args.batch % s[0] == 0]
            if not cands:
                ap.error(f"no alternative mesh shape for {args.mesh} whose "
                         f"data axis divides --batch {args.batch}")
            args.remesh_to = cands[0]
        elif args.batch % args.remesh_to[0] \
                or math.prod(args.remesh_to) > math.prod(args.mesh):
            ap.error(f"--remesh-to {args.remesh_to} must fit the mesh's "
                     f"{math.prod(args.mesh)} ranks with a data axis that "
                     f"divides --batch {args.batch}")
    if args.mesh is not None and math.prod(args.mesh) > 1:
        if args.backend is None:
            ap.error("--mesh: name the collectives' backend with --backend "
                     "(gloo or nccl)")
        if args.controller or args.slo_p95_ms is not None:
            # each rank would degrade on its own wall clock and leave the
            # lockstep the collectives need
            ap.error("--mesh: a controller on a mesh would degrade on each "
                     "rank's own wall clock; serve a mesh without one")
        resolve_device(args.device)
        import torch.multiprocessing as mp
        mp.spawn(_rank_main, args=(args, _free_port()),
                 nprocs=math.prod(args.mesh), join=True)
        return
    _serve(args)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, args, port: int) -> None:
    """One rank of ``--mesh D,M``: its mesh, then ``_serve`` on it (the
    report printed by rank 0 only)."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_mesh(args.mesh, ("data", "model"), backend=args.backend,
                     rank=rank, init_method=f"tcp://localhost:{port}",
                     device=device, timeout=TIMEOUT_S)
    try:
        _serve(args, mesh)
    finally:
        destroy(mesh)


def _serve(args, mesh=None) -> None:
    """The serving run of ``main``; on a mesh every rank runs it on the
    same requests and rank 0 prints."""
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    cfg = get_config(args.arch, args.variant)
    ecfg = get_elastic(args.arch, cfg)
    if args.kv_layout == "paged" and ecfg is not None \
            and getattr(ecfg, "mlp_n_experts", 0):
        # paged prefill is chunked; moefied expert-capacity buffers depend
        # on the chunking, so the paged engine requires a dense MLP
        say(f"[serve] --kv-layout paged: dropping mlp_n_experts="
            f"{ecfg.mlp_n_experts} (dense MLP required)")
        ecfg = dataclasses.replace(ecfg, mlp_n_experts=0, mlp_expert_topk=0)
    if args.depth_routed and ecfg is not None:
        # depth_capacity=1.0 enables the router (spec.depth_routed) while the
        # default policy stays teacher-exact; budgets/controller lower it live
        ecfg = dataclasses.replace(ecfg, depth_capacity=1.0)
    controller = None
    if args.controller or args.slo_p95_ms is not None:
        from repro_torch.runtime.controller import SLOController, SLOTarget
        slo_ms = args.slo_p95_ms if args.slo_p95_ms is not None else 500.0
        controller = SLOController(
            targets={"default": SLOTarget(p95_ttft_ms=slo_ms)},
            floor=args.slo_floor)
    if mesh is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model_init(gen, cfg, ecfg, device=device)
        rp = router_init(gen, cfg, ecfg, device=device)
    else:
        # every rank draws the same tree on the host and copies only its
        # shard to its device (the engine on a mesh takes a shard)
        gen = torch.Generator().manual_seed(0)
        params = shard_params(model_init(gen, cfg, ecfg, device="cpu"),
                              mesh, device=device)
        rp = tree_map(lambda x: x.to(device),
                      router_init(gen, cfg, ecfg, device="cpu"))
    engine = ServingEngine(params, rp, cfg, ecfg, mode=args.mode,
                           controller=controller,
                           batch_size=args.batch,
                           max_seq=args.prompt_len + args.max_new,
                           eos_id=args.eos,
                           step_flop_budget=args.flop_budget,
                           kv_layout=args.kv_layout,
                           page_size=args.page_size, n_pages=args.n_pages,
                           kv_dtype=args.kv_dtype,
                           weight_dtype=args.weight_dtype, device=device,
                           mesh=mesh)
    del params                  # the engine holds its own (cast) tree
    budgets = args.budget
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, args.prompt_len,
                                    dtype=np.int32), args.max_new,
                       budget=(budgets[i % len(budgets)] if budgets else None),
                       temperature=args.temperature, top_k=args.top_k,
                       seed=i)
            for i in range(args.requests)]

    if args.arrival_rate is not None:
        arrive = None
        if args.trace != "poisson":
            arrive = arrival_times(args.trace, args.arrival_rate,
                                   len(reqs), seed=0)
        # warm the captured entry points outside the timed window
        engine.generate([reqs[0]])
        engine.scheduler.reset_stats()
        handles, dt = open_loop(engine, reqs, args.arrival_rate,
                                arrive=arrive, remesh_at=args.remesh_at,
                                remesh_to=args.remesh_to)
        if engine.left:             # outside the re-meshed shape: no report
            return
        n_tok = sum(len(h.output) for h in handles)
        st = latency_stats(handles)
        say(f"open loop: {len(reqs)} requests @ {args.arrival_rate} req/s "
            f"({args.trace}), {n_tok} tokens in {dt:.2f}s "
            f"({n_tok / dt:.1f} tok/s)")
        say(f"latency: e2e mean {st['mean_ms']:.0f} / p50 "
            f"{st['p50_ms']:.0f} / p95 {st['p95_ms']:.0f} ms; "
            f"ttft p50 {st['ttft_p50_ms']:.0f} / p95 "
            f"{st['ttft_p95_ms']:.0f} ms; itl mean "
            f"{st['itl_mean_ms']:.1f} / p95 {st['itl_p95_ms']:.1f} ms; "
            f"slot occupancy {engine.occupancy:.0%} "
            f"(budgets={budgets or 'config-default'})")
        if controller is not None:
            cs = controller.summary()
            served = sum(h.status == "done" for h in handles)
            say(f"controller: admission {cs['admission_budget']:.2f}, "
                f"depth {cs['depth_budget']:.2f}, "
                f"inflight {cs['inflight_budget']:.2f} after "
                f"{cs['evals']} evals; events {cs['events'] or '{}'}; "
                f"served {served}, shed {engine.n_rejected}, expired "
                f"{engine.n_expired} (slo p95 ttft "
                f"{controller.target_for('default').p95_ttft_ms:.0f} ms)")
        if engine.scheduler.n_replicas > 1 or mesh is not None:
            say(replica_report(engine, handles))
    else:
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        say(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
            f"({n_tok / dt:.1f} tok/s, mode={args.mode}, "
            f"budgets={budgets or 'config-default'})")
        say("sample output:", outs[0][:16])
    say(f"compiles: {engine.compile_counts()} (budgets, slots, and "
        f"sampling knobs never recompile)")
    if args.kv_layout == "paged":
        st = engine.paged_stats()
        say(f"paged pool: peak {st['peak_allocated']}/{st['usable']} pages "
            f"(page_size={st['page_size']}, "
            f"{st['registered_prefixes']} prefixes registered)")


if __name__ == "__main__":
    main()
