"""Continuous-batching serving over the port's ring or paged KV cache.

    engine = ServingEngine(params, rp, cfg, spec, mode="infer")
    h = engine.submit(GenRequest(prompt, 64, budget=0.5))
    for tok in h.tokens():         # streams; drives engine.step()
        ...
    engine.cancel(h)               # frees the slot mid-flight

``engine.step()`` admits queued requests into free slots (a single-request
prefill copied into the slot's cache row, and the request's solved policy
row spliced in place into the live (B,)-leaf ``ElasticPolicy``), then runs
ONE decode step over the fixed array of B slots; finished and empty slots
are masked. Admission is packed by ``runtime.scheduler.SlotScheduler``
against a per-step FLOP budget (a request costs its budget fraction).

The engine's entry points are compiled, as the JAX engine jits its own
(``compile_counts()``). Every tensor the decode step reads or writes is
allocated once, at init, and never rebound: the tokens, positions and
``active`` mask, the paged table and trash pages, the per-slot
temperature, top-k and seeds, the live policy leaves and the caches. The
host keeps numpy mirrors of the per-slot state; they are views of one
staging buffer (pinned on the card) that reaches the device in ONE copy a
step, and the new tokens come back in one copy, the step's only sync. On
the card the first call of each form of an entry point runs eagerly (a
real step: its results are the step's) and is then captured into a
``torch.cuda.CUDAGraph``; every later call replays it. The forms: the
decode step greedy-only or sampling (the host tests whether a live slot
samples, as JAX's step branches on the device), and one paged prefill
chunk whose tokens, table row, write page, offsets and policy row are
staged into static buffers, so it is captured ONCE for any mix of prompt
lengths, shared prefixes, forks and preemptions. All graphs of an engine
share one memory pool and are freed with it. A failed capture, or a body
that syncs or reads the host, raises: there is no fallback to eager.
``cuda_graphs=False`` runs every step eagerly on the card (the
counterpart of ``jax.disable_jit()``); a CPU engine builds the same static
state and runs its bodies eagerly, counted the same way. The ring's
one-shot admission prefill, ``fork``'s page copy and the first-token
sampling stay eager.

``kv_layout="paged"`` (``runtime/pagedkv.py``) replaces the ring's
``max_seq`` reservation per slot with a global pool of ``page_size``-token
pages and a per-slot page table: a prompt is prefilled in chunks of one
page, full prompt pages are shared between requests with the same prefix
(refcounted, namespaced by mode, effective budget, theta, KV dtype and
the controller's depth cap), ``fork`` copies only the partial tail page,
and when the pool runs dry the latest-admitted slot is preempted and
re-queued at the front as a continuation. The (B, pages_per_slot) table
and the (B,) trash pages are among the staged per-slot state.

``kv_dtype`` / ``weight_dtype`` (``fp32`` = the config dtype, ``bf16``,
``int8``; ``models/quant.py``) set the storage of the caches and of the
base weights: the engine quantizes (or casts) the weights once, at init,
into a new tree (the caller's stays as it is), and builds its caches in
``kv_dtype``; int8 K/V are quantized once at each cache write and the
kernels read the stored codes with their scales.

The context families (a VLM, an encoder-decoder; ring layout only, as in
the JAX engine) take each request's context as ``extra_inputs`` (one
``image_embeds`` or ``frames`` row with a leading dim of 1): the admission
prefill projects (and, encoder-decoder, encodes) it, selects its tokens
with the request's policy row and writes each ``xattn`` layer's context
K/V into the slot's row of the ring cache, in place, so a replayed decode
graph reads the new request's context. A request's extras are dropped
when it is admitted, finishes, is cancelled, expires or is shed.

``mode`` is ``"infer"`` (the threshold routing of §B.1 at admission and
decode), ``"base"`` (the frozen teacher) or, on the ring layout,
``"train"``: each admission prefills with the top-k (train-mode) routing,
its one ``RoutingPlan`` per block sized by the request's static ragged
capacity bucket (``policy.ragged_bucket``: at most
``routing.RAGGED_N_BUCKETS`` per prompt length, the identity path at full
budget), its k/v scattered back to their positions for the ring; through
the plan the dense MLPs run the ``fused_mlp_routed`` kernel, with int8
weights too. The admission is eager like the infer one, and decode is the
same threshold step in every mode, so the decode forms do not change.

``controller`` (``runtime/controller.SLOController``) closes the loop on
the budget knob, as in the JAX engine: queued requests whose deadline
passed are dropped before admission (``deadline_exceeded``), admissions
are capped at the controller's degraded budget and depth (policy row and
scheduler cost), and after each decode the controller evaluates; its
in-flight and depth stages splice degraded rows into the live policy in
place (``ElasticPolicy.set_row_``), which a replayed decode graph reads,
so no stage captures anything new, and its shed stage rejects queued
requests with a Retry-After hint. Every request timestamp comes from one
injected ``clock`` (default ``time.perf_counter``), so a fake clock gives
a deterministic budget trajectory; ``timing`` stays on the wall clock.
``reshard`` re-meshes the engine live (below; on one device a drain that
drops its graphs); ``runtime/fault_tolerance`` drives it on a failure or
an escalation.

``mesh`` (a ``runtime.mesh.Mesh`` of shape (data=D, model=M)): serving on
a mesh, ring or paged, in ``infer`` / ``base`` mode, the JAX engine's SPMD
contract. Every rank builds its own engine over its shard of the weights,
taken on the host before the engine is built
(``runtime/sharding.shard_params``, ``interop.params_from_numpy(mesh=)``;
a whole tree raises); the rank at (d, m) holds model shard m and replica
d's ``B/D`` slots of the ring cache, or replica d's ``N/D`` pages of the
pool (its trash page included), at its kv-heads. Every rank submits the
same requests at the same steps and runs the same host scheduler over
all B flat slots (flat slot i lives on replica i // (B/D)), so admission,
page and preemption decisions agree on every rank; the page pool's
bookkeeping (``paged_stats``) is host state every rank holds whole. A
rank makes model calls only for its own replica's slots: an admission
prefills on its replica's ranks while the other replicas go on, and the
model-axis collectives run on the replica's own model group. The sampled
tokens cross the replicas once per decode step (``collectives.exchange``
over the data group: each slot's token and its ``active`` flag, which
every rank checks against its own), and on a step that admits, with the
first tokens: on the ring once after the step's admissions, which the
replicas prefill side by side; on the paged layout once after each
admission, since a first token can end its request and free its pages
before the next admission allocates, as the JAX engine appends it (the
pool's counts, ``peak_allocated`` too, follow that order). Sampling is keyed on (seed, position), so a token does not
depend on the replica that drew it. (Admissions or degradations driven by
each rank's own wall clock would break the lockstep: give a controller on
a mesh one injected clock.) Every model call runs under ``with mesh:``
(the collectives, ``runtime/collectives.py``). Collectives cannot be
captured in a CUDA graph, so a mesh engine runs eagerly
(``cuda_graphs=True`` raises); ``compile_counts()`` still counts the
decode step's forms, whose launch signatures do not change across
budgets, slots or sampling settings. ``reshard(mesh)`` re-meshes live
onto another shape of the same process world, or onto one device
(``None``), moving every in-flight request's cache rows. ``mode="train"``
and int8 weights on a mesh raise (ROADMAP Queue A item 11, part 4), as do
graphed decode (part 6).

Decode runs the ElastiFormer threshold path (§B.1). Each slot samples with
its request's temperature, top-k and seed (``sample_tokens``): the noise
of a token is keyed on (seed, its position) only, so a request's stream is
the same served alone or staggered, forked with its seed, or preempted and
resumed. Temperature 0 (the default) is the exact argmax; a greedy-only
step takes the argmax alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.policy import (ElasticPolicy, ElasticSpec,
                                     as_spec_policy, ragged_bucket,
                                     solve_budget)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as OPS
from repro_torch.runtime.mesh import Mesh
from repro_torch.models.attention import check_kernel_ok
from repro_torch.models.layers import dtype_of
from repro_torch.models.quant import (check_kv_dtype, check_weight_dtype,
                                      quantize_params_tree)
from repro_torch.models.model import (cache_init, check_mesh, decode_step,
                                     paged_cache_init, prefill_chunk_step,
                                     prefill_into_slot)
from repro_torch.runtime import collectives as C
from repro_torch.runtime import elastic as EL
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.pagedkv import (PagePool, copy_page_in_tree,
                                        n_pages_for, prefix_keys)
from repro_torch.runtime.scheduler import RequestHandle, SlotScheduler


class EntryPoint(NamedTuple):
    """One entry point of the engine (or the trainer) with arguments shaped
    and built exactly as a live call's: what ``repro_torch.analysis``
    records and lints (the JAX engine's ``EntryPoint``). ``inplace``: the
    paths of the tensors the call must write in place, each an argument
    index (or a keyword's name) then the keys into it (the JAX engine's
    ``donated``); ``graphed``: an entry the engine captures into a CUDA
    graph on the card (on the CPU it runs the same body eagerly), whose
    replay repeats the captured operations whatever the arguments'
    values."""
    fn: object
    args: tuple
    kwargs: dict
    inplace: tuple = ()
    graphed: bool = False


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int = 32
    budget: Optional[float] = None   # compute budget in (0, 1]; None = engine default
    eos_id: Optional[int] = None     # stop token; None = engine/config default
    temperature: float = 0.0         # 0.0 = greedy (the exact argmax)
    top_k: int = 0                   # sample from the top-k logits; 0 = all
    seed: int = 0                    # per-request PRNG seed (32 bits used)
    slo_class: str = "default"       # tenant SLO class (runtime/controller.py)
    deadline_ms: Optional[float] = None  # queue deadline; None = class default


def sample_tokens(logits, temperature=None, top_k=None, seeds=None,
                  positions=None):
    """Per-row sampling. logits: (B, V); temperature, top_k, seeds and
    positions: (B,) tensors, or None for greedy decoding of every row.

    Rows with temperature <= 0 take the exact argmax (first index on ties),
    bit for bit the greedy path. The others take gumbel-max over the
    logits at or above the row's k-th largest (``top_k`` <= 0: all; ties
    all kept) at the row's temperature, the noise drawn from
    ``fold_in(PRNGKey(seed), position of the new token)`` (``core/prng``,
    the JAX package's stream), so a request's samples depend only on its
    seed and positions."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature is None:
        return greedy
    lg = logits.float()
    V = lg.shape[-1]
    k = torch.clamp(torch.where(top_k <= 0, torch.full_like(top_k, V),
                                top_k), 1, V).long()
    kth = torch.sort(lg, dim=-1).values.gather(-1, (V - k)[:, None])
    key = prng.fold_in(prng.PRNGKey(seeds), positions)
    z = torch.where(lg >= kth,
                    lg / torch.clamp(temperature.float(), min=1e-6)[:, None]
                    + prng.gumbel(key, V),
                    torch.full((), -torch.inf, device=lg.device))
    return torch.where(temperature > 0, torch.argmax(z, dim=-1), greedy)


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} arrives with ROADMAP Queue A {item}")


def _staging(fields, device):
    """One host staging buffer for the step's per-slot state (pinned when
    ``device`` is a card, so the copy is asynchronous) and its device
    twin, each laid out as ``fields`` ((name, numpy dtype, shape), every
    field 8-byte aligned). Returns (host buffer, device buffer, {name:
    numpy view of the host buffer}, {name: tensor view of the device
    buffer}): the host writes the views, ONE copy moves them all."""
    offs, n = [], 0
    for _, dt, shape in fields:
        offs.append(n)
        n += -(-int(np.prod(shape)) * np.dtype(dt).itemsize // 8) * 8
    host = torch.zeros((n,), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    dev = torch.zeros((n,), dtype=torch.uint8, device=device)
    arr = host.numpy()
    hv, dv = {}, {}
    for (name, dt, shape), o in zip(fields, offs):
        nb = int(np.prod(shape)) * np.dtype(dt).itemsize
        tdt = torch.from_numpy(np.zeros((), dt)).dtype
        hv[name] = arr[o:o + nb].view(dt).reshape(shape)
        dv[name] = dev[o:o + nb].view(tdt).reshape(shape)
    return host, dev, hv, dv


def _leaf_paths(tree, prefix=()) -> list:
    """Key paths of the tensors of a nested dict / list of tensors."""
    if torch.is_tensor(tree):
        return [prefix]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in _leaf_paths(v, prefix + (k,))]


def _policy_leaves(pol) -> dict:
    """{field: tensor} of a live (B,)- or (L, B)-leaf policy."""
    return {f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)}


class ServingEngine:
    """Continuous-batching generation over a frozen base model + routers.

    ``elastic``: ElasticSpec (or legacy ElasticConfig). Per-request budgets
    go through the roofline budget solver and are spliced into the live
    (B,)-leaf policy at admission. ``step_flop_budget``: per-step FLOP
    budget for admission packing, in full-budget rows (None = limited by
    slots only). ``kv_layout``: ``"ring"`` or ``"paged"`` (``page_size``
    tokens per page, ``n_pages`` pages in the pool, default the
    ring-equivalent ``batch_size * ceil(max_seq / page_size) + 1`` with
    the trash page). ``kv_dtype`` / ``weight_dtype``: the storage of the
    caches and of the base weights (module docstring). ``device``: None =
    the CUDA card (raises without one); ``"cpu"`` runs on the CPU. The
    params must already live there. ``cuda_graphs``: None = True on a CUDA
    engine (the decode step and the paged prefill chunk captured once per
    form and replayed, module docstring); False runs them eagerly on the
    card, as a CPU engine always does. ``compile_counts()`` counts the
    forms built. ``controller``: an ``SLOController`` (module docstring);
    ``clock``: the clock of every request timestamp and controller
    evaluation (default ``time.perf_counter``).
    """

    def __init__(self, params, router_params, cfg, elastic=None,
                 mode: str = "infer", batch_size: int = 8,
                 max_seq: int = 256, default_budget: Optional[float] = None,
                 theta: float = 0.5, eos_id: Optional[int] = None,
                 step_flop_budget: Optional[float] = None, mesh=None,
                 kv_layout: str = "ring", page_size: int = 16,
                 n_pages: Optional[int] = None, kv_dtype: str = "fp32",
                 weight_dtype: str = "fp32", controller=None, clock=None,
                 device=None, cuda_graphs: Optional[bool] = None):
        if mesh is not None:
            self._check_mesh(mesh, cfg, elastic, mode, weight_dtype,
                             cuda_graphs)
            cuda_graphs = False
        if kv_layout not in ("ring", "paged"):
            raise ValueError(f"kv_layout must be 'ring' or 'paged', "
                             f"got {kv_layout!r}")
        self.cfg, self.mode = cfg, mode
        # SLO controller (runtime/controller.py) + injectable clock: every
        # request timestamp (handle t_submit/t_tokens, deadlines, controller
        # evaluations) reads this one clock, so tests drive a fully
        # deterministic time; ``timing`` stays on the host's wall clock
        self.controller = controller
        self._clock = clock if clock is not None else time.perf_counter
        self.mesh = mesh                          # None: one device
        self.remeshed_at: Optional[float] = None  # last reshard(), clock time
        self.spec, self._base_policy = as_spec_policy(elastic)
        self.kv_layout, self.page_size = kv_layout, int(page_size)
        self.kv_dtype = check_kv_dtype(kv_dtype)
        self.weight_dtype = check_weight_dtype(weight_dtype)
        if kv_layout == "paged":
            self._validate_paged(mode)
        if mode not in ("infer", "base", "train"):
            raise ValueError(f"mode must be 'infer', 'base' or 'train', "
                             f"got {mode!r}")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.cuda_graphs = on_card if cuda_graphs is None else bool(cuda_graphs)
        if self.cuda_graphs and not on_card:
            raise ValueError("cuda_graphs=True captures CUDA graphs: it needs "
                             "an engine on a CUDA device")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if mesh is not None:
            self._check_shard(params, cfg, mesh)
        # the base weights quantized (or cast) once, into a new tree
        self.params = quantize_params_tree(params, self.weight_dtype)
        self.rp = router_params
        if (self.kv_dtype, self.weight_dtype) != ("fp32", "fp32"):
            # the spec carries the dtypes into the cache write sites, also
            # for plain dense serving (no elastic config), as in JAX
            base = self.spec if self.spec is not None else ElasticSpec()
            self.spec = dataclasses.replace(base, kv_dtype=self.kv_dtype,
                                            weight_dtype=self.weight_dtype)
            if self._base_policy is None:
                self._base_policy = ElasticPolicy.uniform(1.0, static=True)
        if self._base_policy is not None:
            self._base_policy = self._base_policy.replace(theta=theta)
        self.B, self.max_seq = batch_size, max_seq
        self.default_budget, self.theta = default_budget, theta
        self.eos_id = eos_id if eos_id is not None else cfg.eos_id
        self._policy_cache: dict = {}
        self._use_policy = self.spec is not None and mode != "base"

        B = batch_size
        self.scheduler = SlotScheduler(B, step_flop_budget,
                                       self._replicas_for(mesh))
        self.left = False                  # left the mesh at a re-mesh
        self.pool: Optional[PagePool] = None
        if kv_layout == "paged":
            R_ = self.scheduler.n_replicas
            self.pages_per_slot = n_pages_for(max_seq, self.page_size)
            if n_pages is None:
                # ring-equivalent memory: every slot at full length, plus
                # one trash page per replica for masked writes
                n_pages = B * self.pages_per_slot + R_
            self.pool = PagePool(n_pages, self.page_size, n_replicas=R_)
            self._caches = paged_cache_init(cfg, n_pages, self.page_size,
                                            device=self.device,
                                            kv_dtype=self.kv_dtype)
            self._admit_counter = itertools.count()
            self._admit_seq = np.full((B,), -1, np.int64)
        else:
            self._caches = cache_init(cfg, B, max_seq, device=self.device,
                                      kv_dtype=self.kv_dtype)
        if mesh is not None:      # the rank's slots (or pages) and kv-heads
            self._caches = SH.shard_caches(self._caches, cfg, mesh)
        # the per-slot state every decode step reads: host mirrors of all
        # B slots and the device copies of the rank's own, which the
        # compiled step reads (never rebound off a mesh)
        self._fields = [("seeds", np.int64, ()),      # uint32 values
                        ("temp", np.float32, ()), ("topk", np.int32, ()),
                        ("t", np.int32, ()),          # decode position
                        ("active", np.bool_, ())]
        if kv_layout == "paged":
            self._fields += [("table", np.int32, (self.pages_per_slot,)),
                             ("trash", np.int32, ())]
        self._set_local(mesh)
        self._h = None
        self._stage()
        self._seeds, self._temp, self._topk = (self._h["seeds"],
                                               self._h["temp"],
                                               self._h["topk"])
        self._t, self._active = self._h["t"], self._h["active"]
        if kv_layout == "paged":
            self._table, self._trash = self._h["table"], self._h["trash"]
            self._table[:] = -1
            self._trash[:] = [self.pool.trash_page(
                self.scheduler.replica_of(s)) for s in range(B)]
            # the captured chunk's inputs: every chunk of one admission
            # staged at once (tokens, table row, write page, pos0, plen per
            # row), one row copied into ``_chunk_in`` before each replay
            C, P = self.page_size, self.pages_per_slot
            self._chunk_host = torch.zeros(
                (P, C + P + 3), dtype=torch.int32, pin_memory=on_card)
            self._chunk_dev = torch.zeros((P, C + P + 3), dtype=torch.int32,
                                          device=self.device)
            self._chunk_in = torch.zeros((C + P + 3,), dtype=torch.int32,
                                         device=self.device)
            self._chunk_logits = torch.zeros(
                (1, cfg.padded_vocab), dtype=dtype_of(cfg), device=self.device)
            self._chunk_policy = (ElasticPolicy.uniform(1.0, static=True).to(
                self.device) if self._use_policy else None)
        self._live_policy = (self._base_policy.broadcast_rows(
            self._bl).to(self.device) if self._use_policy else None)
        self._tok = torch.zeros((self._bl,), dtype=torch.int64,
                                device=self.device)
        self._ngen = np.zeros((B,), np.int64)
        # per-slot budget bookkeeping for in-flight degradation: the budget
        # the slot was ADMITTED at (None = engine default / base policy),
        # the budget currently APPLIED to its live policy row, and the
        # controller depth cap applied to it (None = undegraded)
        self._slot_budget_key: list = [None] * B
        self._slot_applied_key: list = [None] * B
        self._slot_applied_depth: list = [None] * B
        self.n_rejected = 0                       # shed under overload
        self.n_expired = 0                        # queue deadline passed
        self._extras: dict = {}                   # handle.id -> extra inputs
        # the compiled entry points: (entry, form) -> None (eager) or
        # (captured graph, kernel launches per replay)
        self._forms: dict = {}
        self._compiles = {"prefill": 0, "decode": 0}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        self.n_preempted = 0                      # paged: evictions so far
        # host wall time of admissions (prefill) and decode steps; both end
        # in a device-to-host copy, which waits for the device
        self.timing = {"prefill_s": 0.0, "prefill_tokens": 0,
                       "decode_s": 0.0, "decode_steps": 0,
                       "decode_tokens": 0}

    @staticmethod
    def _check_mesh(mesh, cfg, elastic, mode, weight_dtype,
                    cuda_graphs) -> None:
        """What a mesh engine serves (module docstring); the rest raises,
        naming the part of ROADMAP Queue A item 11 that brings it."""
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a runtime.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mode == "train":
            raise _todo("train-mode serving on a mesh",
                        "item 11 (part 4, training on a mesh)")
        if weight_dtype == "int8":
            raise _todo("int8 weights on a mesh", "item 11 (part 4, "
                        "training on a mesh, with gradient compression and "
                        "int8 shards)")
        if cuda_graphs:
            raise _todo("graphed decode on a mesh (gloo collectives cannot "
                        "be captured)", "item 11 (part 6, graphed decode "
                        "under TP)")
        with mesh:
            check_mesh(cfg, as_spec_policy(elastic)[0])
            check_kernel_ok(cfg)

    def _replicas_for(self, mesh) -> int:
        """The replica count: the mesh's data axes (1 without a mesh); the
        slot array must split evenly over them."""
        r = SH.data_axis_size(mesh)
        if self.B % r:
            raise ValueError(f"batch_size={self.B} must be a multiple of "
                             f"the replica count {r}")
        return r

    def _set_local(self, mesh) -> None:
        """The rank's flat slots ``[_lo, _lo + _bl)`` (its replica's; all B
        off a mesh or on a data axis of 1) and the first global id of its
        pages (``_page0``)."""
        r = SH.data_axis_size(mesh)
        self._bl = self.B // r
        d = mesh.data_rank if mesh is not None else 0
        self._lo = d * self._bl
        self._page0 = (d * self.pool.pages_per_replica
                       if self.pool is not None else 0)

    def _stage(self) -> None:
        """(Re)build the staging of the rank's per-slot state: one host
        buffer (pinned on the card) and its device twin, laid out by
        ``_fields`` at the rank's ``_bl`` slots. Off a mesh the host views
        ARE the engine's host mirrors (``_h``); on a mesh the mirrors hold
        all B slots and ``_stage_local`` copies the rank's rows in before
        each step's copy."""
        fields = [(n, dt, (self._bl,) + tail) for n, dt, tail in self._fields]
        self._stage_host, self._stage_dev, self._hl, self._dev = _staging(
            fields, self.device)
        if self._h is None:
            self._h = self._hl if self.mesh is None else {
                n: np.zeros((self.B,) + tail, dt)
                for n, dt, tail in self._fields}

    def _stage_local(self) -> None:
        """The rank's rows of the host mirrors into the staging buffer (a
        no-op off a mesh, where they are the same arrays)."""
        if self._hl is self._h:
            return
        for n, v in self._hl.items():
            v[...] = self._h[n][self._lo:self._lo + self._bl]

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s row in the rank's device state, or None when another
        replica holds it."""
        i = int(slot) - self._lo
        return i if 0 <= i < self._bl else None

    @staticmethod
    def _check_shard(params, cfg, mesh) -> None:
        """A mesh engine serves the rank's shard of the weights, never a
        whole tree: shard on the host before building it
        (``runtime/sharding.shard_params(..., device=)`` or
        ``interop.params_from_numpy(mesh=)``)."""
        want = cfg.n_heads_p // mesh.model_size
        got = params["layers"][0]["attn"]["wq"].shape[1]
        if got != want:
            raise ValueError(
                f"a mesh engine takes rank {mesh.model_rank}'s shard of the "
                f"weights ({want} q-heads in wq), got {got}: shard the tree "
                f"with runtime.sharding.shard_params before building the "
                f"engine")

    def _on_mesh(self):
        """``with self._on_mesh():`` runs a model call on the engine's mesh
        (nothing off a mesh)."""
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    # ---------------------------- paged KV mode ------------------------------

    def _validate_paged(self, mode: str) -> None:
        """The paged layout serves global self-attention layers with dense
        MLPs, as the JAX engine does: recurrent mixers have no paged
        state, windows would need page eviction, and expert dispatch sizes
        its capacity buffers by the prefill chunking (chunked and one-shot
        prefills could drop different tokens). The context families
        (encoder, VLM, encoder-decoder) are refused too: a cross-attention
        context has no page form."""
        if mode not in ("infer", "base"):
            raise ValueError(f"kv_layout='paged' serves infer/base modes, "
                             f"got mode={mode!r}")
        if self.cfg.encoder is not None or self.cfg.family in ("vlm",
                                                               "encoder"):
            raise ValueError("kv_layout='paged' serves decoder-only LMs")
        bad = [k for k in self.cfg.layer_kinds if k != "attn"]
        if bad:
            raise ValueError(f"kv_layout='paged' requires all-'attn' layer "
                             f"kinds, got {sorted(set(bad))}")
        if any(w and w > 0 for w in self.cfg.layer_windows):
            raise ValueError("kv_layout='paged' does not support sliding-"
                             "window layers")
        if self.cfg.moe is not None or (self.spec is not None
                                        and self.spec.mlp_n_experts):
            raise ValueError("kv_layout='paged' requires a dense MLP (no "
                             "MoE / moefied experts): expert-capacity "
                             "buffers depend on the prefill chunking")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")

    def _prefix_namespace(self, req: GenRequest) -> tuple:
        """Prefix-sharing hash namespace: pages hold post-gate K/V, so two
        requests may share a page only when every knob that shapes the
        written values agrees — mode, the solved budget (capped by the
        controller), theta, the KV storage dtype and the controller's depth
        cap (sampling knobs don't touch K/V)."""
        b = self._effective_budget(req)
        d = self._depth_cap()
        return (self.mode, None if b is None else round(float(b), 6),
                round(float(self.theta), 6), self.kv_dtype,
                None if d is None else round(float(d), 6))

    def paged_stats(self) -> dict:
        """Pool stats plus live-token page efficiency (host side only)."""
        st = self.pool.stats()
        live_tok = int(self._t[self._active].sum())
        held = int(sum((self._table[s] >= 0).sum()
                       for s in range(self.B) if self._active[s]))
        st["live_tokens"] = live_tok
        st["pages_held_by_active"] = held
        st["pages_per_token"] = (held / live_tok) if live_tok else 0.0
        return st

    # ---- budgets -> per-request policy rows ----
    def _effective_budget(self, req: GenRequest) -> Optional[float]:
        """A request's serving budget: its own (or the engine default),
        capped by the controller's degraded admission budget. A requested
        budget BELOW the cap is kept as it is: the cap only degrades, never
        upgrades."""
        b = req.budget if req.budget is not None else self.default_budget
        if self.controller is not None:
            cap = self.controller.admission_cap()
            if cap is not None:
                b = cap if b is None else min(float(b), cap)
        return b

    def _depth_cap(self) -> Optional[float]:
        """The controller's depth-stage cap (whole-layer skips), honoured
        only when the spec routes depth: otherwise the knob has nothing to
        act on and is ignored."""
        if (self.controller is None or self.spec is None
                or not self.spec.depth_routed):
            return None
        return self.controller.depth_cap()

    def _policy_for(self, budget: Optional[float],
                    depth: Optional[float] = None) -> Optional[ElasticPolicy]:
        """Solved policy row for (budget, depth cap) as f32 tensors on the
        device. ``depth`` caps ``depth_capacity`` below what the roofline
        solver chose for the budget (the controller's depth stage); rows
        are cached per (budget, depth) key, so repeat admissions and
        splices never re-solve."""
        if not self._use_policy:
            return None
        key = (None if budget is None else round(float(budget), 6),
               None if depth is None else round(float(depth), 6))
        if key not in self._policy_cache:
            pol = (self._base_policy if key[0] is None else solve_budget(
                self.cfg, self.spec, key[0], theta=self.theta, static=True))
            if depth is not None:
                cur = pol.depth_capacity
                pol = pol.replace(depth_capacity=(
                    min(float(cur), key[1]) if isinstance(cur, (int, float))
                    else torch.minimum(
                        torch.as_tensor(cur, dtype=torch.float32),
                        torch.tensor(key[1], dtype=torch.float32))))
            self._policy_cache[key] = pol.to(self.device)
        return self._policy_cache[key]

    @staticmethod
    def _composed_cost(budget: Optional[float],
                       depth: Optional[float]) -> float:
        """Scheduler cost of a (budget, depth cap) pair: the budget fraction
        times the depth fraction. Depth skips whole layers, so the two
        compose multiplicatively, like the roofline solver's active-FLOP
        model."""
        return min(1.0, (1.0 if budget is None else float(budget))
                   * (1.0 if depth is None else float(depth)))

    # ------------------------- request lifecycle -----------------------------

    def submit(self, request: GenRequest,
               extra_inputs: Optional[dict] = None) -> RequestHandle:
        """Queue a request; returns its lifecycle handle. ``extra_inputs``:
        per-request model inputs with a leading dim of 1 (a VLM's one
        ``image_embeds`` row, an encoder-decoder's ``frames``), moved to
        the engine's device here."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + request.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq={self.max_seq}")
        b = request.budget
        if b is not None and not 0.0 < b <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {b}")
        if self.kv_layout == "paged":
            need = n_pages_for(prompt.size + request.max_new_tokens,
                               self.page_size)
            if need > self.pool.usable_per_replica:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.pool.usable_per_replica} usable pages")
        handle = RequestHandle(request, engine=self, clock=self._clock)
        handle.tenant = request.slo_class or "default"
        dl_ms = request.deadline_ms
        if dl_ms is None and self.controller is not None:
            dl_ms = self.controller.target_for(handle.tenant).deadline_ms
        if dl_ms is not None:
            handle.deadline = handle.t_submit + float(dl_ms) / 1e3
        extras = self._context_inputs(extra_inputs)
        if extras:
            self._extras[handle.id] = extras
        cost = b if b is not None else (self.default_budget or 1.0)
        self.scheduler.enqueue(handle, cost=min(1.0, float(cost)))
        return handle

    def _context_inputs(self, extra_inputs: Optional[dict]) -> dict:
        """``extra_inputs`` checked against the model's family and moved to
        the engine's device: a VLM takes exactly one ``image_embeds`` row
        (1, n_image_tokens, d_frontend), an encoder-decoder one ``frames``
        row (1, encoder_seq, the encoder's input width), any other model
        none. Raises ValueError otherwise, before the request is queued."""
        cfg, extra_inputs = self.cfg, extra_inputs or {}
        if cfg.family == "vlm":
            key = "image_embeds"
            shape = (1, cfg.n_image_tokens, cfg.d_frontend or cfg.d_model)
        elif cfg.encoder is not None:
            key, e = "frames", cfg.encoder
            shape = (1, cfg.encoder_seq, e.d_frontend or e.d_model)
        elif extra_inputs:
            raise ValueError(f"{cfg.name} takes no extra_inputs, got "
                             f"{sorted(extra_inputs)}")
        else:
            return {}
        if set(extra_inputs) != {key}:
            raise ValueError(f"{cfg.name} needs extra_inputs with exactly "
                             f"{key!r}, got {sorted(extra_inputs)}")
        v = torch.as_tensor(extra_inputs[key], device=self.device)
        if tuple(v.shape) != shape:
            raise ValueError(f"{cfg.name}: {key} must have shape {shape}, "
                             f"got {tuple(v.shape)}")
        return {key: v}

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a queued or running request; frees its slot immediately.
        Returns False if the request had already finished."""
        if handle.done:
            return False
        if handle.status == "running" and handle.slot is not None:
            if self.kv_layout == "paged":
                self._free_slot_pages(handle.slot)
            self.scheduler.free(handle.slot)
            self._active[handle.slot] = False
        else:
            self.scheduler.drop_queued(handle)
        self._extras.pop(handle.id, None)
        handle.finish("cancelled")
        return True

    @property
    def has_work(self) -> bool:
        """Requests running or queued (a rank that left the mesh has
        none)."""
        return not self.left and (self.scheduler.active > 0
                                  or self.scheduler.pending > 0)

    @property
    def occupancy(self) -> float:
        return self.scheduler.occupancy

    # ------------------------------ stepping ---------------------------------

    def _admit_one(self, slot: int, handle: RequestHandle):
        """Ring admission of ``handle`` into ``slot``: the slot's host
        state on every rank, and, on the ranks of the slot's replica, the
        eager one-request prefill (the cache row, the context caches too,
        and the policy row spliced in place). Returns the first token as a
        device tensor on those ranks, None on the others."""
        req = handle.request
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        self._set_sampling(slot, req)
        self._t[slot] = prompt.size
        self._active[slot] = True
        self._ngen[slot] = 0
        extras = self._extras.pop(handle.id, {})
        i = self._local(slot)
        if i is None:
            return None
        t0 = time.perf_counter()
        tokens = torch.as_tensor(prompt[None], device=self.device)
        pol_row = self._policy_for(self._effective_budget(req),
                                   depth=self._depth_cap())
        args, kw = self._admit_args({"tokens": tokens, **extras}, i, pol_row)
        with self._on_mesh():
            logits, _, _ = prefill_into_slot(*args, **kw)
        tok0 = self._sample_first(logits, slot, prompt.size)
        self._tok[i] = tok0
        self.timing["prefill_s"] += time.perf_counter() - t0
        self.timing["prefill_tokens"] += int(prompt.size)
        return tok0

    def _admitted(self, pending: list) -> None:
        """The first tokens of admissions ``pending`` ((slot, handle,
        tok0), tok0 a device tensor on the ranks of the slot's replica,
        else None) reach every rank's host (one ``exchange`` on a data
        axis above 1), then each admission is appended and noted, in
        admission order."""
        if not pending:
            return
        if self._bl == self.B:
            toks = [int(tok0) for _, _, tok0 in pending]
        else:
            t0 = time.perf_counter()
            local = torch.full((self._bl,), -1, dtype=torch.int64)
            for slot, _, tok0 in pending:
                if tok0 is not None:
                    local[self._local(slot)] = int(tok0)
            allt = C.exchange(local, self.mesh)
            toks = [int(allt[slot]) for slot, _, _ in pending]
            self.timing["prefill_s"] += time.perf_counter() - t0
        for (slot, handle, _), tok in zip(pending, toks):
            self._append(slot, handle, tok)
            self._note_admitted(slot, handle,
                                self._effective_budget(handle.request),
                                self._depth_cap())

    def _admit_args(self, batch: dict, slot: int, pol_row) -> tuple:
        """(args, kwargs) of the ring admission's ``prefill_into_slot``:
        top-k (train-mode) routing plans its blocks into the request's
        static capacity bucket; threshold (infer) prefill takes none."""
        bucket = None
        if (self._use_policy and self.mode == "train"
                and self.spec.routing_impl == "ragged"):
            bucket = ragged_bucket(pol_row, batch["tokens"].shape[1],
                                   spec=self.spec)
        return ((self.params, self.rp, batch, self._caches, slot, self.cfg,
                 self.spec),
                dict(mode=self.mode, max_cache_len=self.max_seq,
                     policy=pol_row, live_policy=self._live_policy,
                     bucket=bucket))

    def _note_admitted(self, slot: int, handle: RequestHandle,
                       b_eff: Optional[float],
                       d_eff: Optional[float] = None) -> None:
        """Records the admitted budget (and depth cap) for in-flight
        degradation and restore, the served-budget weight for goodput
        accounting, and the TTFT sample for the controller. The slot's
        scheduler cost is re-priced to the COMPOSED budget x depth
        fraction, so a depth-degraded engine's admission headroom grows to
        match the FLOPs it actually spends."""
        self._slot_budget_key[slot] = b_eff
        self._slot_applied_key[slot] = b_eff
        self._slot_applied_depth[slot] = d_eff
        cost = self._composed_cost(b_eff, d_eff)
        handle.budget_served = cost
        if d_eff is not None:
            self.scheduler.reprice(slot, cost)
        if self.controller is not None and handle.ttft is not None:
            self.controller.record_ttft(
                handle.tenant, self.scheduler.replica_of(slot),
                handle.ttft * 1e3, t=handle.t_first)

    def _set_sampling(self, slot: int, req: GenRequest) -> None:
        """Records the request's sampling settings in ``slot``."""
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._seeds[slot] = int(req.seed) & 0xFFFFFFFF

    def _sample_first(self, logits, slot: int, plen: int):
        """The first token (position ``plen``) from the prefill's logits,
        with the slot's sampling settings (eager)."""
        if self._temp[slot] <= 0:
            return sample_tokens(logits)[0]
        dev, sl = self.device, [slot]
        return sample_tokens(
            logits, torch.as_tensor(self._temp[sl], device=dev),
            torch.as_tensor(self._topk[sl], device=dev),
            torch.as_tensor(self._seeds[sl], device=dev),
            torch.full((1,), plen, dtype=torch.int32, device=dev))[0]

    # ----------------------- paged admission / decode ------------------------

    def _page_check(self, handle: RequestHandle, replica: int) -> bool:
        """Admission hook of ``SlotScheduler.admit``: the head is admitted
        only when the freelist covers the prompt's full page count
        (conservative: prefix sharing can only reduce it)."""
        plen = np.asarray(handle.request.prompt).size
        return self.pool.can_alloc(replica, n_pages_for(plen, self.page_size))

    def _free_slot_pages(self, slot: int) -> None:
        """Return a slot's page-table row to the pool (refcounted: shared
        prefix pages survive until their last holder frees) and clear it."""
        pages = [int(p) for p in self._table[slot] if p >= 0]
        if pages:
            self.pool.free(pages)
        self._table[slot] = -1

    def _admit_one_paged(self, slot: int, handle: RequestHandle) -> tuple:
        """Paged admission: match shared prefix pages, allocate the rest,
        then stream the prompt through ``prefill_chunk_step``, one page of
        tokens per call. Fully shared chunks are skipped — except the FINAL
        chunk, which always runs (its activations give the first token);
        when that chunk's page is shared, its write goes to the trash page
        while attention reads the real shared page. The pool's bookkeeping
        runs on every rank, the chunks on the ranks of the slot's replica.
        Returns (False, None) when the pool cannot back the prompt right
        now (the caller re-queues), else (True, the first token as a
        device tensor on the slot's replica, None elsewhere)."""
        req = handle.request
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        plen, ps = prompt.size, self.page_size
        n_chunks = n_pages_for(plen, ps)
        n_full = plen // ps                  # full pages eligible to share
        r = self.scheduler.replica_of(slot)
        keys = prefix_keys(tuple(int(x) for x in prompt), ps,
                           namespace=self._prefix_namespace(req))
        row = np.full(self.pages_per_slot, -1, np.int32)
        matched = 0
        for i in range(n_full):
            pg = self.pool.lookup_prefix(keys[i], r)
            if pg is None:
                break
            self.pool.incref(pg)
            row[i] = pg
            matched += 1
        fresh = self.pool.alloc(r, n_chunks - matched) \
            if n_chunks > matched else []
        if fresh is None:                    # raced out inside this batch
            shared = [int(p) for p in row[:matched]]
            if shared:
                self.pool.free(shared)
            return False, None
        for j, pg in enumerate(fresh):
            row[matched + j] = pg
        self._table[slot] = row
        self._set_sampling(slot, req)
        self._t[slot] = plen
        self._active[slot] = True
        self._ngen[slot] = 0
        self._admit_seq[slot] = next(self._admit_counter)
        li = self._local(slot)
        tok0 = None
        if li is not None:                   # the slot's replica prefills
            tok0 = self._prefill_chunks(slot, li, req, prompt, row, matched,
                                        self.pool.trash_page(r))
        for i in range(matched, n_full):     # freshly written full pages
            self.pool.register_prefix(keys[i], int(row[i]))
        return True, tok0

    def _prefill_chunks(self, slot: int, li: int, req: GenRequest, prompt,
                        row, matched: int, trash: int):
        """The device side of a paged admission: stage every chunk it runs
        (the chunks past the ``matched`` shared pages, or the last one) in
        one copy, replay the captured chunk once per chunk from its row of
        the staging, splice the policy row into the rank's row ``li`` and
        sample the first token (a device tensor)."""
        plen, ps, P = prompt.size, self.page_size, self.pages_per_slot
        n_chunks = n_pages_for(plen, ps)
        pol_row = self._policy_for(self._effective_budget(req),
                                   depth=self._depth_cap())
        t0 = time.perf_counter()
        runs = list(range(matched, n_chunks)) or [n_chunks - 1]
        stage = self._chunk_host.numpy()
        for j, c in enumerate(runs):
            lo = c * ps
            n = min(ps, plen - lo)
            stage[j, :ps] = 0
            stage[j, :n] = prompt[lo:lo + n]
            stage[j, ps:ps + P] = row
            stage[j, ps + P:] = (row[c] if c >= matched else trash, lo, plen)
        self._chunk_dev[:len(runs)].copy_(self._chunk_host[:len(runs)],
                                          non_blocking=True)
        if pol_row is not None:
            self._chunk_policy.copy_(pol_row)
        for j in range(len(runs)):
            self._chunk_in.copy_(self._chunk_dev[j])
            self._run_form("prefill", "chunk", self._chunk_body)
        if self._live_policy is not None and pol_row is not None:
            self._live_policy.set_row_(li, pol_row)
        tok0 = self._sample_first(self._chunk_logits, slot, plen)
        self._tok[li] = tok0
        self.timing["prefill_s"] += time.perf_counter() - t0
        self.timing["prefill_tokens"] += int(plen)
        return tok0

    def _pick_victim(self, replica: int) -> Optional[int]:
        """Preemption order: the LATEST-admitted active slot of the replica
        (FIFO priority: the request that has waited longest keeps its
        pages)."""
        spr = self.scheduler.slots_per_replica
        cands = [s for s in range(replica * spr, (replica + 1) * spr)
                 if self._active[s]]
        return max(cands, key=lambda s: self._admit_seq[s]) if cands else None

    def _preempt(self, slot: int) -> None:
        """Evict a running request under page pressure: recycle its pages,
        free the slot, and re-queue it AT THE FRONT as a continuation
        (prompt := original + generated so far). The continuation keeps
        its seed and the noise is keyed on absolute positions, so it
        continues token for token as if never interrupted."""
        handle = self.scheduler.slots[slot]
        cost = self.scheduler.costs[slot]
        self._free_slot_pages(slot)
        self._active[slot] = False
        self.scheduler.free(slot)
        req = handle.request
        prompt = np.concatenate([
            np.asarray(req.prompt, np.int32).reshape(-1),
            np.asarray(handle.output, np.int32)])
        handle.request = dataclasses.replace(
            req, prompt=prompt,
            max_new_tokens=req.max_new_tokens - len(handle.output))
        self.n_preempted += 1
        self.scheduler.requeue_front(handle, cost)

    def _ensure_decode_pages(self) -> None:
        """Before the decode step: every active slot whose next write
        position crosses into an unbacked table entry gets a fresh page,
        preempting the latest-admitted slot when the freelist is dry
        (possibly the requester itself)."""
        for slot in np.nonzero(self._active)[0]:
            if not self._active[slot]:    # preempted by an earlier iteration
                continue
            pi = int(self._t[slot]) // self.page_size
            if pi >= self.pages_per_slot or self._table[slot, pi] >= 0:
                continue
            r = self.scheduler.replica_of(int(slot))
            while True:
                pg = self.pool.alloc(r, 1)
                if pg is not None:
                    self._table[slot, pi] = pg[0]
                    break
                victim = self._pick_victim(r)
                if victim is None:
                    raise RuntimeError("page pool exhausted with no "
                                       "preemptible slot")
                self._preempt(victim)
                if victim == slot:           # requester evicted itself
                    break

    def _append(self, slot: int, handle: RequestHandle, tok: int) -> None:
        handle.append(tok)
        self._ngen[slot] += 1
        eos = (handle.request.eos_id if handle.request.eos_id is not None
               else self.eos_id)
        if self._ngen[slot] >= handle.request.max_new_tokens:
            self._finish(slot, handle, "length")
        elif eos is not None and tok == int(eos):
            self._finish(slot, handle, "eos")

    def _finish(self, slot: int, handle: RequestHandle, reason: str) -> None:
        self._extras.pop(handle.id, None)
        handle.finish(reason)
        if self.kv_layout == "paged":
            self._free_slot_pages(slot)
        self.scheduler.free(slot)
        self._active[slot] = False

    def _expire(self) -> int:
        """Drops queued requests whose deadline has passed, BEFORE they
        burn a prefill (reason ``deadline_exceeded``)."""
        expired = self.scheduler.expire_deadlines(self._clock())
        for h in expired:
            self._extras.pop(h.id, None)
        self.n_expired += len(expired)
        return len(expired)

    def _apply_inflight(self) -> None:
        """In-flight degradation: splices the controller's depth cap and
        in-flight budget into every active slot's live policy row in place
        (``set_row_``, floored at the controller's floor; a replayed decode
        graph reads the leaves, so nothing is captured again) and re-prices
        the slot's scheduler cost to the composed budget x depth fraction.
        Restores splice the ADMITTED row back when the controller
        releases."""
        c = self.controller
        if c is None or self._live_policy is None:
            return
        tgt = c.inflight_budget
        dcap = self._depth_cap()
        for s in np.nonzero(self._active)[0]:
            s = int(s)
            adm = self._slot_budget_key[s]
            if tgt < 1.0:
                want = tgt if adm is None else min(float(adm), tgt)
            else:
                want = adm
            if (want == self._slot_applied_key[s]
                    and dcap == self._slot_applied_depth[s]):
                continue
            li = self._local(s)
            if li is not None:                # the rank's own rows only
                self._live_policy.set_row_(
                    li, self._policy_for(want, depth=dcap), floor=c.floor)
            self._slot_applied_key[s] = want
            self._slot_applied_depth[s] = dcap
            cost = self._composed_cost(want, dcap)
            self.scheduler.reprice(s, cost)
            handle = self.scheduler.slots[s]
            if handle is not None:
                handle.budget_served = min(handle.budget_served, cost)

    def _control(self) -> int:
        """One controller evaluation (rate-limited inside ``update``):
        applies in-flight budget moves and sheds queued requests with a
        Retry-After hint. Returns the number of shed requests (they are
        resolved: progress events)."""
        c = self.controller
        if c is None:
            return 0
        dec = c.update(self._clock(), queue_depth=self.scheduler.pending,
                       capacity=self.B)
        if not dec["evaluated"]:
            return 0
        self._apply_inflight()
        if not dec["shed"]:
            return 0
        victims = self.scheduler.shed(
            dec["shed"],
            priority=lambda h: c.target_for(h.tenant).shed_order)
        for h in victims:
            h.retry_after = c.retry_after(dec["ratio"])
            self._extras.pop(h.id, None)
        self.n_rejected += len(victims)
        return len(victims)

    def step(self) -> int:
        """Admit queued requests into free slots, then run ONE decode step
        over the slot array. Returns the number of progress events
        (admissions + slots that advanced + expired and shed requests);
        0 = the engine is idle.

        Paged mode: admission packs on free pages and the FLOP budget
        together (``_page_check``); an admission that runs out of pages
        inside the batch is re-queued at the front; before the decode,
        slots crossing into a new page get one, preempting under page
        pressure. On a data axis each first token reaches every rank
        before the next paged admission allocates (a first token that
        ends its request frees its pages first, as in the JAX engine); the
        ring's first tokens cross once, after the step's admissions.

        With an ``SLOController``: expired queue deadlines are dropped
        before admission, admissions are capped at the degraded budget
        (cost AND policy row), and the controller evaluates at the end of
        the step, after the inter-token samples of its decode."""
        if self.left:
            raise RuntimeError("this rank left the mesh at a re-mesh: it "
                               "serves no more")
        paged = self.kv_layout == "paged"
        expired = self._expire()
        cap = (self.controller.admission_cap()
               if self.controller is not None else None)
        dcap = self._depth_cap()
        # paged: a first token can end its request and free pages, so it
        # is appended before the next admission allocates (JAX's order);
        # ring: the replicas prefill side by side, then one exchange
        n_admitted, pending = 0, []
        for slot, handle in self.scheduler.admit(
                page_check=self._page_check if paged else None,
                cost_cap=cap, cost_scale=dcap):
            if paged:
                self._admitted(pending)
                pending = []
                ok, tok0 = self._admit_one_paged(slot, handle)
                if not ok:
                    cost = self.scheduler.costs[slot]
                    self.scheduler.free(slot)
                    self.scheduler.requeue_front(handle, cost)
                    continue
            else:
                tok0 = self._admit_one(slot, handle)
            n_admitted += 1
            pending.append((slot, handle, tok0))
        self._admitted(pending)
        if paged:
            self._ensure_decode_pages()       # may preempt: before `live`
        if not self._active.any():
            return n_admitted + expired + self._control()
        live = [(s, h) for s, h in enumerate(self.scheduler.slots)
                if h is not None and self._active[s]]
        t0 = time.perf_counter()
        # greedy-only or sampling: decided over every live slot, so every
        # rank builds the same forms
        sampling = bool((self._temp[self._active] > 0).any())
        if self._active[self._lo:self._lo + self._bl].any():
            # the rank's per-slot state in one copy
            self._stage_local()
            self._stage_dev.copy_(self._stage_host, non_blocking=True)
            self._run_form("decode", "sampling" if sampling else "greedy",
                           lambda: self._decode_body(sampling))
            toks = self._tok.cpu()                # waits for the device
        else:                       # a replica with no live slot exchanges
            toks = torch.zeros((self._bl,), dtype=torch.int64)
        toks = self._exchange_tokens(toks)
        self.timing["decode_s"] += time.perf_counter() - t0
        self.timing["decode_steps"] += 1
        self.timing["decode_tokens"] += len(live)
        self.scheduler.tick()
        for slot, handle in live:
            self._t[slot] += 1
            self._append(slot, handle, int(toks[slot]))
        if self.controller is not None:
            for slot, handle in live:
                if len(handle.t_tokens) >= 2:
                    self.controller.record_itl(
                        handle.tenant, self.scheduler.replica_of(slot),
                        (handle.t_tokens[-1] - handle.t_tokens[-2]) * 1e3,
                        t=handle.t_tokens[-1])
        return n_admitted + len(live) + expired + self._control()

    def _exchange_tokens(self, toks: torch.Tensor) -> np.ndarray:
        """The step's sampled tokens of all B slots on every rank: the
        rank's own (``toks``, its ``_bl`` rows) all-gathered with its
        ``active`` flags over the data axis (``collectives.exchange``);
        every rank checks the gathered flags against its own host state,
        so replicas whose schedulers parted raise instead of serving on.
        Off a data axis ``toks`` itself."""
        if self._bl == self.B:
            return toks.numpy()
        lo, bl = self._lo, self._bl
        mine = torch.stack([toks, torch.from_numpy(
            self._active[lo:lo + bl].astype(np.int64))], dim=1)
        both = C.exchange(mine, self.mesh).numpy()
        if not np.array_equal(both[:, 1].astype(bool), self._active):
            raise RuntimeError(
                f"rank {self.mesh.rank}: the replicas' schedulers parted "
                f"(active slots {both[:, 1].tolist()} gathered, "
                f"{self._active.astype(int).tolist()} here)")
        return both[:, 0]

    # --------------------------- compiled entry points ------------------------

    def _decode_args(self, sampling: bool) -> tuple:
        """The decode entry point's arguments: the engine's static buffers
        (tokens, caches, positions, live policy, ``active``; sampling: the
        temperatures, top-k and seeds; paged: the table and trash pages)."""
        dev = self._dev
        args = (self.params, self.rp, self._tok, self._caches, dev["t"],
                self._live_policy, dev["active"])
        if sampling:
            args += (dev["temp"], dev["topk"], dev["seeds"])
        if self.kv_layout == "paged":
            args += (None,) * (10 - len(args)) + (dev["table"],
                                                  dev["trash"])
        return args

    def _decode_fn(self, params, rp, tok, caches, t, policy, active,
                   temp=None, topk=None, seeds=None, table=None,
                   trash=None) -> None:
        """The decode entry point: one ``decode_step`` over the slot array,
        ``sample_tokens`` (the new token sits at t + 1; greedy-only when
        ``temp`` is None) and the ``active`` mask; the new tokens land in
        ``tok`` in place."""
        paged_kw = {} if table is None else dict(table=table, trash=trash)
        logits, _ = decode_step(
            params, rp, tok[:, None], caches, t, self.cfg, self.spec,
            mode=self.mode, policy=policy, **paged_kw)
        if temp is not None:
            nxt = sample_tokens(logits, temp, topk, seeds, t + 1)
        else:                      # every live slot greedy: no sort, no noise
            nxt = sample_tokens(logits)
        tok.copy_(torch.where(active, nxt, torch.zeros_like(nxt)))

    def _decode_body(self, sampling: bool) -> None:
        """One decode step over the engine's static buffers."""
        self._decode_fn(*self._decode_args(sampling))

    def _chunk_args(self) -> tuple:
        """The paged prefill entry point's arguments: the staged chunk row
        ``_chunk_in``, the caches, ``_chunk_policy`` and ``_chunk_logits``."""
        return (self.params, self.rp, self._chunk_in, self._caches,
                self._chunk_policy, self._chunk_logits)

    def _chunk_fn(self, params, rp, ci, caches, policy, logits_out) -> None:
        """The paged prefill entry point: one ``prefill_chunk_step`` whose
        tokens, table row, write page, pos0 and plen are views of ``ci``;
        its logits land in ``logits_out`` in place."""
        C, P = self.page_size, self.pages_per_slot
        logits, _ = prefill_chunk_step(
            params, rp, ci[None, :C], caches, ci[C + P], ci[C:C + P],
            ci[C + P + 1], ci[C + P + 2], self.cfg, self.spec,
            mode=self.mode, policy=policy)
        logits_out.copy_(logits)

    def _chunk_body(self) -> None:
        """One paged prefill chunk over the engine's static buffers."""
        self._chunk_fn(*self._chunk_args())

    def _cache_paths(self, index: int) -> tuple:
        """Paths (``index``, "layers", i, leaf) of every cache tensor a step
        writes in place (a context cache is written at admission only)."""
        return tuple((index, "layers", i, *keys)
                     for i, layer in enumerate(self._caches["layers"])
                     for keys in _leaf_paths(layer) if keys[0] != "xattn")

    def entry_points(self, plen: int = 8, budget: Optional[float] = 0.5,
                     depth: Optional[float] = None) -> dict:
        """The engine's entry points with arguments built by the code paths
        a live call uses (``_admit_args``, ``_decode_args``,
        ``_chunk_args``), as ``EntryPoint``s: what ``repro_torch.analysis``
        lints, so a lint can never drift from the real call. A ring engine:
        ``admit`` (the eager ``prefill_into_slot`` of a ``plen``-token
        prompt at ``budget`` into slot 0) and ``decode`` (the greedy-only
        form); a paged engine: ``chunk`` (one staged prefill chunk) and
        ``decode``. Calling an entry writes the engine's buffers: the
        analysis passes call them on copies."""
        decode = EntryPoint(self._decode_fn, self._decode_args(False), {},
                            inplace=((2,),) + self._cache_paths(3),
                            graphed=True)
        if self.kv_layout == "paged":
            chunk = EntryPoint(self._chunk_fn, self._chunk_args(), {},
                               inplace=self._cache_paths(3) + ((5,),),
                               graphed=True)
            return {"chunk": chunk, "decode": decode}
        prompt = np.arange(1, plen + 1, dtype=np.int32) \
            % max(2, self.cfg.vocab_size)
        pol_row = self._policy_for(budget if self._use_policy else None,
                                   depth=depth)
        batch = {"tokens": torch.as_tensor(prompt[None], device=self.device)}
        args, kw = self._admit_args(batch, 0, pol_row)
        admit = EntryPoint(prefill_into_slot, args, kw,
                           inplace=self._cache_paths(3))
        return {"admit": admit, "decode": decode}

    def _run_form(self, entry: str, form: str, body) -> None:
        """Runs ``body``, the form ``form`` of the entry point ``entry``.
        A form's first call builds it (``compile_counts``): the body runs
        eagerly, a real step, and on a graphed engine is then captured
        into a CUDA graph in the engine's pool (a failed capture raises;
        nothing the capture records runs). Every later call replays the
        graph, which counts the kernel launches it makes, or runs the body
        eagerly (``cuda_graphs=False``, the CPU)."""
        key = (entry, form)
        with torch.no_grad(), self._on_mesh():
            if key in self._forms:
                built = self._forms[key]
                if built is None:
                    body()
                else:
                    graph, launches = built
                    graph.replay()
                    OPS.count_replay(launches)
                return
            self._compiles[entry] += 1
            body()
            if not self.cuda_graphs:
                self._forms[key] = None
                return
            graph = torch.cuda.CUDAGraph()
            with OPS.captured_launches() as launches, \
                    torch.cuda.graph(graph, pool=self._graph_pool):
                body()
            self._forms[key] = (graph, launches)

    def compile_counts(self) -> dict:
        """``{"prefill": n, "decode": m}``: the forms of each entry point
        this engine has built (on the card each is one captured CUDA
        graph), the JAX engine's ``compile_counts()``. A paged engine
        builds one chunk form (prefill 1 after its first admission; a ring
        engine's admission is eager: 0, in every mode, where the JAX
        engine compiles one prefill per prompt length and, train mode,
        per capacity bucket) and at most two decode forms, greedy-only and
        sampling, whatever the mode, budgets, buckets, slots, prompt
        lengths and sampling settings."""
        return dict(self._compiles)

    def reshard(self, mesh) -> None:
        """LIVE re-mesh, the JAX engine's ``reshard``: the engine moves onto
        ``mesh`` (a ``Mesh`` of another (data, model) shape over the same
        process world, from ``launch.mesh.remesh``) or onto one device
        (``None``: the world's rank 0 serves on), without a restart.
        Every rank of the current mesh calls it with the same shape.

        The device drains; the slot caches (every in-flight request), the
        live policy rows and the last tokens are gathered over the mesh
        through the host (``collectives.gather_mesh``) and re-sliced by the
        new mesh's cache rules, kv-heads included when the model axis
        changes; the weights keep their shard when the model axis stays
        (every rank keeps its model coordinate), else are gathered over
        the mesh like the caches and re-sliced. Routers are
        whole on every rank. The queue, the slot assignments and the host
        state stay; the scheduler re-derives its replica axis
        (``SlotScheduler.set_replicas``), ``remeshed_at`` is stamped and
        ``compile_counts()`` restarts. A rank outside the new mesh drains
        and leaves the lockstep (``left``; it serves no more). Every
        in-flight request continues with the tokens of an uninterrupted
        run. On one device (no mesh before or after) it is a drain that
        keeps every slot and drops the captured graphs. A paged engine
        refuses, as the JAX engine does; a one-device engine has no
        process world to move onto a mesh (ValueError)."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a runtime.mesh.Mesh or None, got "
                            f"{type(mesh).__name__}")
        if self.kv_layout == "paged":
            raise NotImplementedError(
                "live reshard of a paged engine is not supported: page ids "
                "are replica-local (the pool freelists and trash pages are "
                "derived from the data-axis size at construction)")
        if self.left:
            raise RuntimeError("this rank left the mesh at a re-mesh")
        old = self.mesh
        if old is None and mesh is not None:
            raise ValueError(
                "a one-device engine has no process world to re-mesh onto: "
                "build the engines on a mesh (launch.mesh.make_mesh) and "
                "re-mesh between shapes of its world")
        n_rep = self._replicas_for(mesh)
        if mesh is not None:
            if mesh.group is None and mesh.member:
                raise RuntimeError("a re-mesh onto an abstract mesh (no "
                                   "process group): build it with "
                                   "launch.mesh.remesh")
            with mesh:
                check_mesh(self.cfg, self.spec)
                check_kernel_ok(self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # drain the in-flight step
        if old is not None:
            self._move_state(old, mesh)
        self.scheduler.set_replicas(n_rep)
        self._forms = {}
        self._compiles = {"prefill": 0, "decode": 0}
        if self.cuda_graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
        self.remeshed_at = self._clock()          # stats-window boundary

    def _move_state(self, old: Mesh, new: Optional[Mesh]) -> None:
        """The device state of every slot from ``old``'s layout to
        ``new``'s (``reshard``): the weights and caches through
        ``elastic.rescale_serving_state``, the last tokens and the live
        policy rows gathered and re-sliced over the slots; a rank outside
        ``new`` keeps nothing and leaves."""
        meta = cache_init(self.cfg, self.B, self.max_seq, device="meta",
                          kv_dtype=self.kv_dtype)
        self.params, self.rp, self._caches = EL.rescale_serving_state(
            self.params, self.rp, self._caches, self.cfg, old, new,
            template=meta, device=self.device)
        rows = [self._tok] + ([] if self._live_policy is None else list(
            _policy_leaves(self._live_policy).values()))
        spec = lambda mesh, t: SH.slot_spec(t.dim(), t.dim() - 1, mesh)
        rows = [EL.gather(t, spec(old, t), old) for t in rows]
        self.mesh = new
        if self._caches is None:              # outside the new mesh
            self.left = True
            self._live_policy = self._tok = None
            return
        rows = [EL.reshard(t, new, spec(new, t), self.device) for t in rows]
        self._tok = rows[0]
        if self._live_policy is not None:
            self._live_policy = self._live_policy.replace(
                **dict(zip(_policy_leaves(self._live_policy), rows[1:])))
        self._set_local(new)
        self._stage()

    # ------------------------------- fork ------------------------------------

    def fork(self, handle: RequestHandle,
             max_new_tokens: Optional[int] = None,
             seed: Optional[int] = None) -> RequestHandle:
        """Copy-on-write fork of a RUNNING paged request: the child takes a
        free slot, shares every FULL page of the parent's history by
        refcount, and copies only the partial tail page (``n_keep`` lanes
        kept). The child continues from the parent's exact decode state
        with the parent's sampling settings, its seed replaced by ``seed``
        when given: with the same seed (or greedy) its tokens match an
        independent run fed prompt + parent-output-so-far. Parent and
        child then append into their OWN tail pages."""
        if self.kv_layout != "paged":
            raise ValueError("fork() requires kv_layout='paged'")
        if handle.status != "running" or handle.slot is None:
            raise ValueError("fork() requires a running request")
        s = handle.slot
        r = self.scheduler.replica_of(s)
        free = self.scheduler.free_slots_in(r)
        if not free:
            raise RuntimeError(f"no free slot on replica {r} to fork into")
        req = handle.request
        remaining = (req.max_new_tokens - len(handle.output)
                     if max_new_tokens is None else int(max_new_tokens))
        if remaining <= 0:
            raise ValueError("nothing left to generate for the fork")
        dst = self.pool.alloc(r, 1)
        if dst is None:
            raise RuntimeError(f"no free page on replica {r} to fork")
        dst = dst[0]
        cs = free[0]
        t = int(self._t[s])
        n_full, rem = t // self.page_size, t % self.page_size
        row = np.full(self.pages_per_slot, -1, np.int32)
        for i in range(n_full):
            row[i] = self._table[s, i]
            self.pool.incref(int(row[i]))
        # the child's append page: a copy of the parent's partial tail (rem
        # lanes kept), or a blank page when the tail is page-aligned
        # (n_keep = 0 masks every lane; src = dst copies nothing new)
        row[n_full] = dst
        src = int(self._table[s, n_full]) if rem else dst
        ls, lc = self._local(s), self._local(cs)
        if ls is not None:              # the replica's ranks copy the page
            copy_page_in_tree(self._caches, src - self._page0,
                              dst - self._page0, rem)
            self._tok[lc] = self._tok[ls]
        self._table[cs] = row
        prompt = np.concatenate([np.asarray(req.prompt, np.int32).reshape(-1),
                                 np.asarray(handle.output, np.int32)])
        creq = dataclasses.replace(req, prompt=prompt,
                                   max_new_tokens=remaining,
                                   seed=req.seed if seed is None else seed)
        child = RequestHandle(creq, engine=self, clock=self._clock)
        child.tenant = handle.tenant
        child.slot, child.status = cs, "running"
        child.budget_served = handle.budget_served
        self.scheduler.slots[cs] = child
        self.scheduler.costs[cs] = self.scheduler.costs[s]
        self._t[cs] = t
        self._temp[cs] = creq.temperature
        self._topk[cs] = creq.top_k
        self._seeds[cs] = int(creq.seed) & 0xFFFFFFFF
        self._active[cs] = True
        self._ngen[cs] = 0
        self._admit_seq[cs] = next(self._admit_counter)
        # the child's row: its request's own budget, as the JAX engine
        # splices it, recorded as the slot's admitted and applied budget
        b = req.budget if req.budget is not None else self.default_budget
        self._slot_budget_key[cs] = self._slot_applied_key[cs] = b
        self._slot_applied_depth[cs] = None
        if self._live_policy is not None and lc is not None:
            self._live_policy.set_row_(lc, self._policy_for(b))
        return child

    def generate(self, requests: List[GenRequest],
                 extra_inputs: Optional[dict] = None,
                 budget: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous batch API: submit everything, step until done.
        ``budget`` overrides every request's budget for this call;
        ``extra_inputs`` leaves carry a leading dim indexed per request."""
        handles = []
        for i, r in enumerate(requests):
            if budget is not None:
                r = dataclasses.replace(r, budget=budget)
            extra = None
            if extra_inputs:
                extra = {k: v[i:i + 1] for k, v in extra_inputs.items()}
            handles.append(self.submit(r, extra_inputs=extra))
        while not all(h.done for h in handles):
            if self.step() == 0 and not all(h.done for h in handles):
                raise RuntimeError("serving engine stalled")
        return [np.asarray(h.output, np.int32) for h in handles]
