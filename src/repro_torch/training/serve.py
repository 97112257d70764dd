"""Continuous-batching greedy serving over the port's ring KV cache.

    engine = ServingEngine(params, rp, cfg, spec, mode="infer")
    h = engine.submit(GenRequest(prompt, 64, budget=0.5))
    for tok in h.tokens():         # streams; drives engine.step()
        ...
    engine.cancel(h)               # frees the slot mid-flight

``engine.step()`` admits queued requests into free slots (a single-request
prefill copied into the slot's cache row, and the request's solved policy
row spliced into the live (B,)-leaf ``ElasticPolicy``), then runs ONE decode
step over the fixed array of B slots; finished and empty slots are masked.
Admission is packed by ``runtime.scheduler.SlotScheduler`` against a
per-step FLOP budget (a request costs its budget fraction). Budgets,
slots and positions are tensor arguments, so every decode step has the same
shapes and dtypes whatever the budget mix.

Decode runs the ElastiFormer threshold path (§B.1). This slice samples
greedily (exact argmax); ``temperature > 0`` needs the JAX package's
threefry sample stream and raises until it is ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.policy import ElasticPolicy, as_spec_policy, solve_budget
from repro_torch.device import resolve_device
from repro_torch.models.model import cache_init, decode_step, prefill_into_slot
from repro_torch.runtime.scheduler import RequestHandle, SlotScheduler


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int = 32
    budget: Optional[float] = None   # compute budget in (0, 1]; None = engine default
    eos_id: Optional[int] = None     # stop token; None = engine/config default
    temperature: float = 0.0         # 0.0 = greedy (the only mode of this slice)
    top_k: int = 0
    seed: int = 0


def sample_tokens(logits):
    """Greedy decoding: the argmax of each row (first index on ties)."""
    return torch.argmax(logits, dim=-1)


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} arrives with ROADMAP Queue A {item}")


class ServingEngine:
    """Continuous-batching generation over a frozen base model + routers.

    ``elastic``: ElasticSpec (or legacy ElasticConfig). Per-request budgets
    go through the roofline budget solver and are spliced into the live
    (B,)-leaf policy at admission. ``step_flop_budget``: per-step FLOP
    budget for admission packing, in full-budget rows (None = limited by
    slots only). ``device``: None = the CUDA card (raises without one);
    ``"cpu"`` runs on the CPU. The params must already live there.
    """

    def __init__(self, params, router_params, cfg, elastic=None,
                 mode: str = "infer", batch_size: int = 8,
                 max_seq: int = 256, default_budget: Optional[float] = None,
                 theta: float = 0.5, eos_id: Optional[int] = None,
                 step_flop_budget: Optional[float] = None, mesh=None,
                 kv_layout: str = "ring", kv_dtype: str = "fp32",
                 weight_dtype: str = "fp32", controller=None, device=None):
        if mesh is not None:
            raise _todo("SPMD serving (mesh=)", "item 11")
        if kv_layout != "ring":
            raise _todo(f"kv_layout={kv_layout!r}", "item 8")
        if (kv_dtype, weight_dtype) != ("fp32", "fp32"):
            raise _todo("quantized KV caches and weights", "item 9")
        if controller is not None:
            raise _todo("the SLO controller", "item 10")
        if mode not in ("infer", "base"):
            raise _todo(f"mode={mode!r} prefill", "items 3-4")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params, self.rp = params, router_params
        self.cfg, self.mode = cfg, mode
        self.spec, self._base_policy = as_spec_policy(elastic)
        if self._base_policy is not None:
            self._base_policy = self._base_policy.replace(theta=theta)
        self.B, self.max_seq = batch_size, max_seq
        self.default_budget, self.theta = default_budget, theta
        self.eos_id = eos_id if eos_id is not None else cfg.eos_id
        self._policy_cache: dict = {}
        self._use_policy = self.spec is not None and mode != "base"

        B = batch_size
        self.scheduler = SlotScheduler(B, step_flop_budget)
        self._caches = cache_init(cfg, B, max_seq, device=self.device)
        self._live_policy = (self._base_policy.broadcast_rows(B).to(
            self.device) if self._use_policy else None)
        self._tok = torch.zeros((B,), dtype=torch.int64, device=self.device)
        self._t = np.zeros((B,), np.int32)        # per-slot decode position
        self._active = np.zeros((B,), bool)
        self._ngen = np.zeros((B,), np.int64)
        # host wall time of admissions (prefill) and decode steps; both end
        # in a device-to-host copy, which waits for the device
        self.timing = {"prefill_s": 0.0, "prefill_tokens": 0,
                       "decode_s": 0.0, "decode_steps": 0,
                       "decode_tokens": 0}

    # ---- budgets -> per-request policy rows ----
    def _policy_for(self, budget: Optional[float]) -> Optional[ElasticPolicy]:
        """Solved policy row for ``budget`` as f32 tensors on the device,
        cached per budget."""
        if not self._use_policy:
            return None
        key = None if budget is None else round(float(budget), 6)
        if key not in self._policy_cache:
            pol = (self._base_policy if key is None else solve_budget(
                self.cfg, self.spec, key, theta=self.theta, static=True))
            self._policy_cache[key] = pol.to(self.device)
        return self._policy_cache[key]

    # ------------------------- request lifecycle -----------------------------

    def submit(self, request: GenRequest) -> RequestHandle:
        """Queue a request; returns its lifecycle handle."""
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
        if request.temperature > 0:
            raise _todo("sampling at temperature > 0 (the threefry sample "
                        "stream)", "item 13")
        handle = RequestHandle(request, engine=self)
        cost = b if b is not None else (self.default_budget or 1.0)
        self.scheduler.enqueue(handle, cost=min(1.0, float(cost)))
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a queued or running request; frees its slot immediately.
        Returns False if the request had already finished."""
        if handle.done:
            return False
        if handle.status == "running" and handle.slot is not None:
            self.scheduler.free(handle.slot)
            self._active[handle.slot] = False
        else:
            self.scheduler.drop_queued(handle)
        handle.finish("cancelled")
        return True

    @property
    def has_work(self) -> bool:
        return self.scheduler.active > 0 or self.scheduler.pending > 0

    @property
    def occupancy(self) -> float:
        return self.scheduler.occupancy

    # ------------------------------ stepping ---------------------------------

    def _admit_one(self, slot: int, handle: RequestHandle) -> None:
        req = handle.request
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        t0 = time.perf_counter()
        tokens = torch.as_tensor(prompt[None], device=self.device)
        b_eff = req.budget if req.budget is not None else self.default_budget
        logits, self._caches, self._live_policy = prefill_into_slot(
            self.params, self.rp, {"tokens": tokens}, self._caches, slot,
            self.cfg, self.spec, mode=self.mode, max_cache_len=self.max_seq,
            policy=self._policy_for(b_eff), live_policy=self._live_policy)
        tok0 = sample_tokens(logits)[0]
        self._tok[slot] = tok0
        tok0 = int(tok0)                          # waits for the device
        self.timing["prefill_s"] += time.perf_counter() - t0
        self.timing["prefill_tokens"] += int(prompt.size)
        self._t[slot] = prompt.size
        self._active[slot] = True
        self._ngen[slot] = 0
        handle.budget_served = min(1.0, 1.0 if b_eff is None else float(b_eff))
        self._append(slot, handle, tok0)

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
        handle.finish(reason)
        self.scheduler.free(slot)
        self._active[slot] = False

    def step(self) -> int:
        """Admit queued requests into free slots, then run ONE decode step
        over the slot array. Returns the number of progress events
        (admissions + slots that advanced); 0 = the engine is idle."""
        admitted = self.scheduler.admit()
        for slot, handle in admitted:
            self._admit_one(slot, handle)
        if not self._active.any():
            return len(admitted)
        live = [(s, h) for s, h in enumerate(self.scheduler.slots)
                if h is not None and self._active[s]]
        t0 = time.perf_counter()
        active = torch.as_tensor(self._active, device=self.device)
        logits, self._caches = decode_step(
            self.params, self.rp, self._tok[:, None], self._caches,
            torch.as_tensor(self._t, device=self.device), self.cfg,
            self.spec, mode=self.mode, policy=self._live_policy)
        self._tok = torch.where(active, sample_tokens(logits),
                                torch.zeros_like(self._tok))
        toks = self._tok.cpu().numpy()            # waits for the device
        self.timing["decode_s"] += time.perf_counter() - t0
        self.timing["decode_steps"] += 1
        self.timing["decode_tokens"] += len(live)
        self.scheduler.tick()
        for slot, handle in live:
            self._t[slot] += 1
            self._append(slot, handle, int(toks[slot]))
        return len(admitted) + len(live)

    def generate(self, requests: List[GenRequest],
                 budget: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous batch API: submit everything, step until done.
        ``budget`` overrides every request's budget for this call."""
        handles = []
        for r in requests:
            if budget is not None:
                r = dataclasses.replace(r, budget=budget)
            handles.append(self.submit(r))
        while not all(h.done for h in handles):
            if self.step() == 0 and not all(h.done for h in handles):
                raise RuntimeError("serving engine stalled")
        return [np.asarray(h.output, np.int32) for h in handles]
