#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (built for H100).

    python3 chip_smoke.py [--layers N] [--train-layers N] [--moe-layers N]
                          [--pages N] [--seed S] [--gmm-tile-rows]
    python3 chip_smoke.py --ab PARENT_CHECKOUT [--layers N]

``--ab`` runs only the kernel checks of item 2 (all six kernels;
``moe_gmm`` at one moefied Qwen2-7B call) and the greedy decode of item
3's six staggered requests (ring and paged infer engines and a ring
mode="base" engine, --layers deep, warm ms/step) on another checkout
(unpacked with ``git archive``) and on this one in turns, p c c p, one
process each, on the same seeded inputs: each turn within TOL of the
plain versions, the timed medians and warm decode ms/step per turn,
whether the change beat the parent in every turn at the cases of
``AB_FASTER``, and it fails unless each tree's outputs are equal bit for
bit in its own two turns and the kernels and paths this change leaves
alone (``AB_SAME``) give the same bits in both trees. Without it:

1. Prints the card (nvidia-smi name and power limit), builds the
   hand-written CUDA kernels from src/repro_torch/kernels/csrc with nvcc
   (sm_90a, one process per source, in parallel) and prints the build time,
   ptxas's registers and spills, and the number of tensor-core (HGMMA)
   instructions in each flash_fwd instantiation's SASS and in the MLP's
   tensor-core up and down phases, which run the dense (fused_mlp), routed
   (fused_mlp_routed) and grouped (moe_gmm) modes (fails unless the bf16
   Dh=128 flash kernel and every MLP phase have some).
2. Holds each kernel against its plain PyTorch version at Qwen2-7B shapes,
   in bf16 and f32, with ragged counts, kv_valid holes, a part-filled ring
   (t at the decode kernel's split edges, a slot with every key masked and
   an inactive one) and a routed selection; prints the max error beside the
   tolerance, and times the kernel, the plain version and (attention) one
   SDPA call with CUDA events. The int8 operand forms of four kernels
   (int8 K/V with per-(key, kv-head) scales for both decode kernels, int8
   weights with per-output-channel scales for fused_mlp) are held the same
   way at Qwen2-7B shapes, bf16 and f32 activations, with holes, a masked
   and an inactive slot, each timed beside the same kernel on bf16
   operands (their bound counts int8 at 1 byte plus the f32 scales; no
   single PyTorch call computes an int8-operand function: library none;
   kept under each kernel's "int8" key of the result line) (KV heads shared by enable_gqa; SDPA over K/V
   repeated to the q-heads is printed beside it). The MLP kernels are
   timed at the ring prefill's 512 rows, the training shape and a paged
   prefill chunk's 16 rows (fused_mlp) and at a training step's routed
   bucket (fused_mlp_routed), each beside a cuBLAS bf16 composite of the
   same function (several calls: printed, never library_ms). The attention kernels,
   their plain versions and SDPA are timed twice: back to back (eager) and
   replayed from a CUDA graph (graphed: the device's time without the
   host's cost of issuing each call); the result line's ms, plain_ms and
   library_ms are back-to-back medians in every row, as for the MLP
   kernels, and the attention rows carry the graphed medians beside them
   as graphed_ms, graphed_plain_ms and graphed_library_ms. moe_gmm is held
   to its plain version after each expert path (items 6, 8, 9) at the
   calls that path made: their shapes and group counts are recorded during
   the path and
   replayed (random x and weights in the path's weight layout, bf16 and
   f32, with and without routing weights, exact zeros past every count,
   each output bit-stable across a repeat), the largest timed beside its
   bound and a cuBLAS per-expert composite (printed, never library_ms);
   with --gmm-tile-rows also the tensor-core body at 64- and at 128-row
   tiles.
3. Serving: 6 staggered mixed-budget requests through ``ServingEngine`` at
   Qwen2-7B full width (random bf16 weights from --seed; --layers cuts depth
   only) and fails unless budget-1.0 requests equal a mode="base" engine
   bit for bit, a request served alone equals its staggered tokens, and
   every serving kernel launched during the run. The engines capture their
   entry points as CUDA graphs (the default): the main run is held bit for
   bit to a ``cuda_graphs=False`` twin at the same depth (tokens and every
   cache leaf), and both engines' ``compile_counts()`` are printed and
   gated (ring: prefill 0, decode at most 2 forms). Prints prefill and
   decode rates of the main run, of its twin and of the (warm) teacher
   run, warm decode ms/step, prefill tok/s and the device's busy share
   graphed and eager (in turns, then profiled), and the device kernel time
   of the solo run under torch.profiler.
3b. Paged serving: the same weights and requests through
   ``ServingEngine(kv_layout="paged")`` (page size 16, --pages pages,
   default the ring-equivalent 4 * 64 + 1): fails unless staggered ==
   solo and budget 1.0 == a mode="base" paged engine bit for bit, two
   requests with a common 256-token prefix share its 16 pages and each
   gives its solo tokens, a fork mid-decode and a pool small enough that
   two 512-token requests collide (at least one preemption) complete, the
   pool drains after every run, and paged_decode_attention and fused_mlp
   launched. Prints the rates beside the ring's, paged-vs-ring token
   agreement, whether the fork child and the preempted request match
   their independent runs (reported, not gated: in bf16 K/V written by
   decode and by a chunk may round differently), the solo run's device
   time under torch.profiler, and warm decode of one request on a ring and
   a paged engine in turns, each also profiled per step.
   paged_decode_attention is held to its plain version at the path's
   decode shape (4 slots, 64-entry table rows with -1 holes, an all -1
   row, pvalid holes, shuffled pages), and at the path's own calls: the
   staggered run's calls are recorded (table, t, pvalid) and the heaviest
   decode-step call and prefill-chunk call (16 rows over one table row)
   are replayed in bf16 and f32 and timed.
3c. Quantized serving: the same weights and requests through int8
   engines (``kv_dtype`` and ``weight_dtype`` "int8"; each engine
   quantizes the weights once at init), ring then paged: fails unless
   staggered == solo, budget 1.0 == an int8 mode="base" engine of the
   same layout, (paged) two requests sharing a 256-token prefix each
   equal their solo runs and the pool drains, bit for bit, and the int8
   forms of fused_mlp, decode_attention (ring) and paged_decode_attention
   (paged) launched; the path's heaviest int8 calls are replayed against
   the plain versions. Prints the rates beside the bf16 rows of item 3 /
   3b, the int8-vs-bf16 greedy agreement (not gated), KV and weight bytes
   against a bf16 engine's, and one warm decode profiled beside a bf16
   engine (device ms and operations per step).
3d. int8 fork and preemption: f32 at Qwen2-7B width, 2 layers, paged: a
   fork child mid-page equals its independent run, and two 512-token
   requests on a pool one page short (a preemption) each equal their
   uninterrupted runs, bit for bit.
3e. Train-mode serving: the same weights and requests through
   ``ServingEngine(mode="train")`` on the ring (each admission routes by
   top-k into the request's ragged capacity bucket; the dense MLPs run
   ``fused_mlp_routed``), in bf16 and with int8 weights and K/V (the
   routed kernel's int8 form): fails unless the tokens are in the
   vocabulary, budget-1.0 requests equal the teacher of item 3 (int8:
   item 3c's int8 teacher), request 4 alone equals its staggered run, bit
   for bit, ``compile_counts()`` is {prefill 0, decode 1} and the path's
   kernels launched. Every ``fused_mlp_routed`` call of the int8 run is
   replayed against the plain version (unselected rows exact zeros), the
   heaviest timed beside the kernel on bf16 weights at the same shape.
   Prints each warm admission's bucket and time beside an infer engine's,
   the profiled device time of one admission of each, and the rates.
4. Gradients: the router gradients of one distillation loss at full width,
   2 layers, f32, through the kernels against the same through the plain
   versions.
5. Training: 4 router self-distillation steps through
   ``repro_torch.launch.train`` at Qwen2-7B full width and depth (the
   serving weights; --train-layers cuts depth), seq 512, batch 2, budget
   annealed 1.0 -> 0.5 over 3 steps. Fails unless budget 1.0 gives the
   teacher's hidden states bit for bit and a distillation loss of exactly
   0, a plan step run twice gives the same bits, every loss is finite and
   every training kernel launched. Prints each step's losses, bucket,
   teacher and student times, tokens/s and peak memory.
5b. Depth serving: the slice's spec and routers plus a fresh seeded depth
   router per layer (per-token whole-layer skip), the six staggered
   requests on the ring and on the paged pool: fails unless budget-1.0
   rows equal the mode="base" runs of items 3 and 3b bit for bit, a
   request alone equals its staggered tokens, the pool drains, and
   flash_attention, fused_mlp, decode_attention (ring) and
   paged_decode_attention (paged) launched. The path's flash, decode,
   MLP and paged calls are recorded and the heaviest of each replayed in
   bf16 and f32 against the plain version (rows with no attendable key
   exact zeros). Prints the rates beside the slice's, the share of
   (token, layer) pairs that wrote no K/V per budget (ring ``valid``,
   paged ``pvalid``) and the depth router's own skip share at the
   staggered ring run's prefills; the depth ring path is decoded warm in
   turns against the slice's ring engine.
5c. Depth gradients: item 4 for the depth spec at depth 0.5 and budget
   0.75 on the other knobs (the bucket solved with the spec: 256 rows,
   not the token knobs' 384; every head's router at a partial top-k, so
   no leaf's gradient is structurally zero), every depth router leaf
   non-zero on both paths.
5d. Depth training: item 5's anneal with the depth spec (the same gates,
   every depth router leaf with a non-zero gradient), then the step timed
   at (depth, token) = (1.0, 1.0), (0.75, 1.0), (0.5, 1.0), (0.5, 0.5)
   (wall time), and the last once more under torch.profiler (device
   time).
5e. Controller serving: the slice's weights with item 5b's depth routers
   under an ``SLOController`` (``runtime/controller.py``), 24 requests of
   a ``launch/workloads`` trace (prompts 64-512 and 16-64 new tokens,
   heavy-tailed; interactive 0.75 with p95 TTFT and ITL targets, batch
   0.25 shed first and with a queue deadline; bursty arrivals) on an
   injected ``StepClock`` advanced a fixed tick per step, through
   ``replay``, on the ring (a) and the paged pool (b): fails unless the
   controller walks degrade_admission, degrade_depth, degrade_inflight
   and shed in that order and restores after, shed requests are rejected
   with a Retry-After hint and expired ones deadline_exceeded, none
   prefilled, the controller escalates and ``maybe_escalate`` declines,
   ``compile_counts()`` does not grow after the first degrade, and the
   graphed engine at ``TWIN_LAYERS`` equals its ``cuda_graphs=False`` twin
   in trajectory, events, statuses, tokens and caches (the in-flight
   splices read by a replayed graph). (c1) the fault drill: the requests
   without a controller, all at once, through ``serve_resilient`` with a
   failure injected mid-run and a straggler watchdog: one restart (a
   shape of 8 devices skipped, then ``reshard(None)``), every request
   finished with its fault-free tokens, ``compile_counts()`` restarted at
   the re-mesh and flat after it. (c2) the ring trace on the wall clock:
   every request terminal, ``compile_counts()`` flat; prints
   ``summarize`` (attainment, goodput, TTFT and ITL percentiles, shed and
   expired), the controller's summary and, for (a) and (c2), decode
   ms/step over the degraded steps against the undegraded ones. The
   path's flash, decode, MLP and paged calls are replayed against the
   plain versions, as in item 5b.
5f. Sampled serving: the six requests of item 3 with temperature 0 on the
   first two and 0.7 / 1.0, top-k 0 / 40 and seeds on the rest: fails
   unless the temperature-0 rows equal item 3's greedy tokens, a sampled
   request alone equals its staggered tokens, greedy-only and sampling
   decode steps hand ``decode_step`` tensors of the same shapes and
   dtypes and the sampling steps hand ``sample_tokens`` (B,) settings (a
   host branch skips the sort and noise when no live slot samples), and
   (paged
   pool, f32, 2 layers) a preempted sampled request resumes to its
   uninterrupted run's tokens. Times one ``sample_tokens`` call against
   the greedy argmax at (4, vocab), graphed and eager.
6. Expert serving: the same six requests through the same weights with
   the MLPs moefied into 8 routed experts (views of the dense weights,
   fresh routers): staggered == solo bit for bit, moe_gmm launched; prints
   the rates, and the budget-1.0-vs-teacher logit difference and token
   agreement (reported, not gated: E partial products in bf16).
7. Expert gradients: the check of item 4 for the expert spec, with the
   expert routers' leaves and the same routing decisions on both paths.
8. Expert training: item 5's anneal with the expert spec: finite losses,
   a plan step twice gives the same bits, every expert router leaf gets a
   non-zero gradient, moe_gmm launched.
9. Native MoE serving: Qwen1.5-MoE-A2.7B at full width (qwen2-moe-a2.7b,
   --moe-layers deep, random bf16 weights, its registered elastic config)
   after the Qwen2-7B weights are freed: staggered == solo bit for bit,
   moe_gmm launched; prints the rates.
9b. Native MoE int8 serving: the same model, routers and requests with
   int8 weights and K/V: staggered == solo bit for bit, moe_gmm launched;
   moe_gmm's int8 form (int8 expert stacks, (E, Fe) / (E, D) scales) is
   replayed at that path's calls against the plain version and timed
   beside the kernel on bf16 stacks.
10. Prints one JSON line of per-kernel results (launches by path), the card
   line again, and as the last line {"ok": true, "device": {...}}.

Every serving phase holds its graphed engines to ``cuda_graphs=False``
twins on the same weights and requests, bit for bit (tokens, every cache
and pool leaf, the page table and pool stats): the slice's ring and paged
infer engines at the served depth, the others (teachers, int8,
train-mode, depth, sampled, moefied, native MoE and its int8 form) at
``TWIN_LAYERS`` layers,
the sampled preemption at its 2 f32 layers; every engine's
``compile_counts()`` must be prefill 1 (paged) or 0 (ring) and decode 1
or 2. A graph replay calls no Python wrapper: the launch counts add each
replayed graph's launches (``ops.count_replay``), and the kernel calls
that the path-call checks replay against the plain versions, and the
sampled phase's ``decode_step`` / ``sample_tokens`` records, come from the
eager twins.

The kernel build prints ptxas's registers, shared memory and spills for
every instantiation (the ring and paged modes of the decode kernel among
them).

Any failed phase raises and the script exits non-zero before that line.
TF32 is off for matmuls and cuDNN (both set below): f32 means f32.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}   # H100 SXM dense; f32 off tensor cores
PEAK_BYTES = 3.35e12                          # H100 SXM HBM3
TOL = {"bf16": (1e-2, 1e-2), "f32": (1e-4, 1e-4)}   # (atol, rtol), per element
L2_BYTES = 50 * 2 ** 20                       # H100 SXM L2
SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124"),
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:140"),
    "fused_mlp_routed": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                         "src/repro/kernels/fused_mlp.py:261"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:104"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                "src/repro/kernels/moe_gmm.py:99"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:108"),
}

# kernels each path must launch (the teacher of expert training is dense)
PATH_KERNELS = {
    "serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "paged_serving": ("fused_mlp", "paged_decode_attention"),
    "training": ("flash_attention", "fused_mlp", "fused_mlp_routed"),
    "expert_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "expert_training": ("flash_attention", "fused_mlp", "moe_gmm"),
    "native_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "depth_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "depth_paged_serving": ("fused_mlp", "paged_decode_attention"),
    "depth_training": ("flash_attention", "fused_mlp", "fused_mlp_routed"),
    "sampled_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "quant_serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "quant_paged_serving": ("fused_mlp", "paged_decode_attention"),
    "quant_native_serving": ("flash_attention", "moe_gmm",
                             "decode_attention"),
    "train_serving": ("flash_attention", "fused_mlp", "fused_mlp_routed",
                      "decode_attention"),
    "quant_train_serving": ("flash_attention", "fused_mlp",
                            "fused_mlp_routed", "decode_attention"),
    "controller_serving": ("flash_attention", "fused_mlp",
                           "decode_attention"),
    "controller_paged_serving": ("fused_mlp", "paged_decode_attention"),
    "controller_fault_drill": ("flash_attention", "fused_mlp",
                               "decode_attention"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, reps: int = 5, warmup: int = 5,
            graph: bool = False) -> list:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls,
    measured with CUDA events ``reps`` times after ``warmup`` calls; returns
    the ``reps`` means, sorted (median is the reported time, the ends are
    its spread). With ``graph`` the ``iters`` calls are captured once into
    a CUDA graph, which is replayed: the device's time per call without the
    host's cost of issuing it (wrapper Python, allocation, launch calls),
    which the plain back-to-back form includes wherever it is the larger."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sorted(out)


def device_and_eager_ms(fn, iters: int) -> tuple:
    """(graphed, back-to-back) times of ``fn`` (``cuda_ms``): the attention
    kernels, their plain versions and SDPA run near the host's cost of one
    call, so both are kept."""
    return cuda_ms(fn, iters, graph=True), cuda_ms(fn, iters)


def cycling(fn, n: int):
    """A no-argument callable that calls ``fn(i)`` with i = 0, 1, ..., n-1,
    0, ... in turn (rotates over n input sets)."""
    state = [0]

    def call():
        i = state[0]
        state[0] = (i + 1) % n
        return fn(i)
    return call


def bound_ms(flops: float, nbytes: float, kind: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


class Results:
    """Per-kernel comparison errors and main-case timings."""

    def __init__(self):
        self.rows = {n: {"max_abs_err": 0.0} for n in SOURCES}

    def compare(self, name, case, got, want, kind, quiet=False):
        """Per element: |got - want| <= atol + rtol * |want|. ``quiet``:
        print only a failure (the caller prints a summary). Returns the
        worst err/tol."""
        import torch
        diff = (got.float() - want.float()).abs()
        atol, rtol = TOL[kind]
        tol = atol + rtol * want.float().abs()
        err = float(diff.max())
        worst = float((diff / tol).max())       # <= 1 everywhere to pass
        ok = bool(torch.isfinite(got.float()).all()) and worst <= 1.0
        n_diff = int((got != want).sum())
        if not quiet or not ok:
            print(f"  {name:17s} {case:44s} max_abs_err {err:.3e}  worst "
                  f"err/tol {worst:.3f} (tol atol {atol:g} + rtol {rtol:g} "
                  f"* |plain| per element; {n_diff} of {got.numel()} "
                  f"elements differ)  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        return worst

    def timing(self, name, ms, plain_ms, flops, nbytes, kind, library_ms):
        """Each time is the sorted list from ``cuda_ms``, or a (graphed,
        back-to-back) pair of them from ``device_and_eager_ms``; the
        back-to-back median goes into the result line under its key (one
        clock for every row), the graphed one of a pair beside it as
        graphed_*; the spread is printed."""
        b, by = bound_ms(flops, nbytes, kind)
        med = lambda ts: None if ts is None else ts[len(ts) // 2]
        fmt = lambda ts: ("n/a" if ts is None else f"{med(ts):.4f} ms "
                          f"[{ts[0]:.4f}-{ts[-1]:.4f}]")
        times = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
        text = {}
        for key, ts in times.items():
            if isinstance(ts, tuple):
                self.rows[name][key] = med(ts[1])
                self.rows[name]["graphed_" + key] = med(ts[0])
                text[key] = f"{fmt(ts[0])} graphed, {fmt(ts[1])} eager"
            else:
                self.rows[name][key] = med(ts)
                text[key] = fmt(ts)
        self.rows[name].update(bound_ms=b, bound_by=by)
        print(f"  {name:17s} median [min-max] of 5: kernel {text['ms']}"
              f"  plain {text['plain_ms']}  library {text['library_ms']}  "
              f"bound {b:.4f} ms ({by})")


def mib(tensors) -> float:
    return sum(a.numel() * a.element_size() for a in tensors) / 2 ** 20


def sdpa_ms(name, qt, ks, vs, mask, iters):
    """Library time of one ``scaled_dot_product_attention`` call on the
    kernel's own inputs: q as (B, H, Sq, Dh), each K/V set of ``ks``/``vs``
    ((B, S, K, Dh), rotated in turn) as (B, K, S, Dh) with its KV heads
    shared by ``enable_gqa``. Printed beside it, not returned: the same
    call over K/V repeated to the H q-heads first (H/K times the bytes)."""
    import torch.nn.functional as F
    H, K, n = qt.shape[1], ks[0].shape[2], len(ks)
    gqa = device_and_eager_ms(cycling(
        lambda i: F.scaled_dot_product_attention(
            qt, ks[i].transpose(1, 2), vs[i].transpose(1, 2),
            attn_mask=mask, enable_gqa=True), n), iters)
    rep = lambda a: a.repeat_interleave(H // K, dim=2).transpose(1, 2)
    kxs, vxs = [rep(a) for a in ks], [rep(a) for a in vs]
    full = device_and_eager_ms(cycling(
        lambda i: F.scaled_dot_product_attention(
            qt, kxs[i], vxs[i], attn_mask=mask), n), iters)
    med = lambda ts: (f"{ts[0][len(ts[0]) // 2]:.4f} ms graphed, "
                      f"{ts[1][len(ts[1]) // 2]:.4f} eager")
    print(f"  {name:17s} SDPA, KV heads shared (enable_gqa; the library "
          f"time): {med(gqa)}; over K/V repeated to {H} heads first "
          f"({mib(kxs + vxs):.0f} MiB): {med(full)}")
    return gqa


# ----------------------------- kernel checks ---------------------------------

def _attention_mask(B, S, valid, causal, count):
    """(B, S, S) attendable (query, key) pairs, by array index."""
    import torch
    i = torch.arange(S, device=valid.device)
    m = (i[None, :] <= i[:, None]) if causal else torch.ones(
        S, S, dtype=torch.bool, device=valid.device)
    m = m[None] & valid[:, None, :]
    return m & (i[None, None, :] < count[:, None, None]) & (
        i[None, :, None] < count[:, None, None])


def check_flash(res: Results, rng, dev, H, K, Dh):
    """flash_attention against its plain version: the serving prefill's
    512-token prompt (timed), the training shape (B=2, S=512, a per-row
    count), a prompt that is not a multiple of the 64-row tile, and ragged
    f32 / bf16 counts. Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, B, S, keep fraction, counts, timed)
        ("bf16", 1, 512, 0.6, None, True),
        ("f32", 2, 384, 0.7, [384, 200], False),
        ("bf16", 2, 256, 0.5, [256, 77], False),
        ("bf16", 2, 512, 0.8, [512, 347], False),
        ("bf16", 1, 300, 0.9, None, False),
    ]
    outs = {}
    for kind, B, S, keep, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q = torch.randn(B, S, H, Dh, device=dev).to(dt)
        k = torch.randn(B, S, K, Dh, device=dev).to(dt)
        v = torch.randn(B, S, K, Dh, device=dev).to(dt)
        valid = torch.from_numpy(rng.random((B, S)) < keep).to(dev)
        cnt = None if counts is None else torch.tensor(counts, device=dev,
                                                       dtype=torch.int32)
        kw = dict(kv_valid=valid, kv_count=cnt, causal=True)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, backend="ref", **kw)
        case = f"{kind} B={B} S={S} H={H} K={K} keep={keep} cnt={counts}"
        res.compare("flash_attention", case, got, want, kind)
        outs[case] = got
        if not timed:
            continue
        cvec = torch.full((B,), S, device=dev) if cnt is None else cnt
        mask = _attention_mask(B, S, valid, True, cvec)
        pairs = float(mask.sum()) * H
        # bytes the function needs: q rows inside the count, the K/V rows of
        # keys that are valid and inside the count, every output row, and
        # the validity mask
        live = torch.arange(S, device=dev)[None, :] < cvec[:, None]
        q_rows, kv_rows = int(live.sum()), int((valid & live).sum())
        esz = q.element_size()
        nbytes = ((q_rows + B * S) * H * Dh + 2 * kv_rows * K * Dh) * esz \
            + valid.numel()
        res.timing(
            "flash_attention",
            device_and_eager_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                20),
            device_and_eager_ms(lambda: ops.flash_attention(
                q, k, v, backend="ref", **kw), 5),
            4 * Dh * pairs, nbytes, kind,
            sdpa_ms("flash_attention", q.transpose(1, 2), [k], [v],
                    mask[:, None], 20))
    return outs


def composite_ms(x, wi, wo, wg, tw, act):
    """CUDA-event times of a cuBLAS bf16 composite of the MLP on the
    kernel's inputs (x already gathered): x@wi, x@wg, act*mul, h@wo, *tw.
    Several PyTorch calls, not one: printed as a yardstick, never a
    row's library_ms."""
    import torch.nn.functional as F
    f = F.silu if act == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))

    def run():
        h = x @ wi
        h = f(x @ wg) * h if wg is not None else f(h)
        y = h @ wo
        return y if tw is None else y * tw[..., None].to(y.dtype)
    return cuda_ms(run, 5)


def mlp_timing(res: Results, name, label, run, composite, rows, d, f,
               n_mats, nbytes, kind):
    """Times one MLP case (kernel, plain version) and prints the cuBLAS
    composite beside it. label "main": the row's timing; any other label:
    kept in the row under cases[label] (ms, plain_ms, bound_ms, bound_by)."""
    ms, plain = cuda_ms(run, 5), cuda_ms(lambda: run("ref"), 3)
    flops = 2 * rows * d * f * n_mats
    comp = composite()
    med = lambda ts: ts[len(ts) // 2]
    print(f"  {name:17s} {label}: cuBLAS bf16 composite (x@wi, x@wg, "
          f"act*mul, h@wo, *tw; a yardstick, several calls) {med(comp):.4f} "
          f"ms [{comp[0]:.4f}-{comp[-1]:.4f}]")
    if label == "main":
        res.timing(name, ms, plain, flops, nbytes, kind, None)
        return
    b, by = bound_ms(flops, nbytes, kind)
    res.rows[name].setdefault("cases", {})[label] = dict(
        ms=med(ms), plain_ms=med(plain), composite_ms=med(comp), bound_ms=b,
        bound_by=by)
    print(f"  {name:17s} {label} median [min-max] of 5: kernel "
          f"{med(ms):.4f} ms [{ms[0]:.4f}-{ms[-1]:.4f}]  plain "
          f"{med(plain):.4f} ms  bound {b:.4f} ms ({by})")


def check_fused_mlp(res: Results, dev, D, Fd):
    """fused_mlp against its plain version at Qwen2-7B widths and small
    ones, bf16 (the tensor-core body at widths that are multiples of 64)
    and f32 (the CUDA-core body). Timed, each beside a cuBLAS composite:
    the ring prefill's 512-token call (the row's time), the training shape
    (B=2, T=512) and a paged prefill chunk's 16-row call (bound by the
    weights' bytes). Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, x shape, D, F, act, gated, token weights, counts, timed)
        ("bf16", (1, 512), D, Fd, "swiglu", True, False, None, "main"),
        ("bf16", (2, 512), D, Fd, "swiglu", True, False, None, "train"),
        ("bf16", (1, 16), D, Fd, "swiglu", True, False, None, "chunk"),
        ("bf16", (2, 77), D, Fd, "swiglu", True, True, [77, 30], None),
        ("f32", (2, 96), D, Fd, "swiglu", True, True, [96, 41], None),
        ("f32", (1, 70), 256, 512, "gelu", False, True, [70], None),
    ]
    outs = {}
    for kind, xs, d, f, act, gated, weighted, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = torch.randn(*xs, d, device=dev).to(dt)
        w = lambda a, b: (torch.randn(a, b, device=dev) / a ** 0.5).to(dt)
        wi, wo = w(d, f), w(f, d)
        wg = w(d, f) if gated else None
        tw = torch.rand(*xs, device=dev) if weighted else None
        cnt = None if counts is None else torch.tensor(counts, device=dev,
                                                       dtype=torch.int32)
        run = lambda backend=None: ops.fused_mlp(
            x, wi, wo, wg, tw, cnt, act=act, backend=backend)
        case = f"{kind} x={tuple(x.shape)} F={f} {act} cnt={counts}"
        outs[case] = run()
        res.compare("fused_mlp", case, outs[case], run("ref"), kind)
        if not timed:
            continue
        rows = xs[0] * xs[1]
        n_mats = 3 if gated else 2
        nbytes = (n_mats * d * f + 2 * x.numel()) * x.element_size()
        mlp_timing(res, "fused_mlp", timed, run,
                   lambda: composite_ms(x, wi, wo, wg, tw, act), rows, d, f,
                   n_mats, nbytes, kind)
    return outs


def check_fused_mlp_routed(res: Results, rng, dev, D, Fd):
    """The routed MLP at a training step's shapes: B=2, S=512, a 256-row
    bucket with counts (256, 200) (timed, beside a cuBLAS composite on the
    gathered rows); plus a small ungated case whose bucket is the whole
    sequence. Rows outside the live selection must be exactly zero.
    Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, B, S, Kb, D, F, act, gated, counts, timed)
        ("bf16", 2, 512, 256, D, Fd, "swiglu", True, [256, 200], True),
        ("f32", 2, 512, 256, D, Fd, "swiglu", True, [256, 200], False),
        ("f32", 2, 96, 96, 256, 512, "gelu", False, [96, 0], False),
    ]
    outs = {}
    for kind, B, S, Kb, d, f, act, gated, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = torch.randn(B, S, d, device=dev).to(dt)
        w = lambda a, b: (torch.randn(a, b, device=dev) / a ** 0.5).to(dt)
        wi, wo = w(d, f), w(f, d)
        wg = w(d, f) if gated else None
        # a RoutingPlan's layout: the selection ascending, then the rest
        idx_np = np.stack([np.concatenate([np.sort(p[:c]), np.sort(p[c:Kb])])
                           for p, c in ((rng.permutation(S), c)
                                        for c in counts)])
        idx = torch.from_numpy(idx_np.astype(np.int64)).to(dev)
        tw = torch.rand(B, Kb, device=dev)
        cnt = torch.tensor(counts, device=dev, dtype=torch.int32)
        run = lambda backend=None: ops.fused_mlp_routed(
            x, idx, wi, wo, wg, tw, cnt, act=act, backend=backend)
        got = run()
        case = f"{kind} x={tuple(x.shape)} Kb={Kb} F={f} {act} cnt={counts}"
        outs[case] = got
        res.compare("fused_mlp_routed", case, got, run("ref"), kind)
        live = torch.zeros(B, S, dtype=torch.bool, device=dev)
        for b, c in enumerate(counts):
            live[b, idx[b, :c]] = True
        n_dead = int((~live).sum())
        if got[~live].count_nonzero() != 0:
            fail(f"fused_mlp_routed {kind}: a row outside the selection is "
                 f"not zero")
        print(f"  fused_mlp_routed  {n_dead} rows outside the selection: all "
              f"exactly zero")
        if not timed:
            continue
        rows = sum(counts)
        n_mats = 3 if gated else 2
        esz = x.element_size()
        # each weight once, the selected x rows, the whole (B, S, D) delta,
        # idx and token weights (4 bytes each) and the counts
        nbytes = (n_mats * d * f + rows * d + B * S * d) * esz \
            + B * Kb * 8 + B * 4
        xg = torch.gather(x, 1, idx[..., None].expand(B, Kb, d))
        mlp_timing(res, "fused_mlp_routed", "main", run,
                   lambda: composite_ms(xg, wi, wo, wg, tw, act), rows, d, f,
                   n_mats, nbytes, kind)
    return outs


def _ring(rng, B, L, t, keep):
    """Ring-cache positions written up to per-slot t (slot = pos % L), -1
    for never-written slots, and a routing validity mask."""
    slots = np.arange(L)[None, :]
    tt = np.asarray(t)[:, None]
    pos = np.where(slots <= tt % L, tt - tt % L, tt - tt % L - L) + slots
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    return pos, rng.random((B, L)) < keep


def check_decode_edges(res: Results, rng, dev, H, K, Dh, L):
    import torch
    from repro_torch.kernels import ops
    split = ops.decode_split_plan(L)[0]
    t = np.asarray([split - 1, split, split + 1, 700, 0], np.int32)
    B = len(t)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pos_np, valid_np = _ring(rng, B, L, t, 0.8)
        valid_np[3] = False                    # every key of slot 3 masked
        pos_np[4] = -1                         # slot 4 inactive
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        k = torch.randn(B, L, K, Dh, device=dev).to(dt)
        v = torch.randn(B, L, K, Dh, device=dev).to(dt)
        pos, valid, tv = (torch.from_numpy(a).to(dev)
                          for a in (pos_np, valid_np, t))
        run = lambda backend=None: ops.decode_attention(
            q, k, v, pos, tv, valid, backend=backend)
        outs[f"edges {kind}"] = got = run()
        res.compare("decode_attention", f"{kind} B={B} L={L} t={t.tolist()} "
                    f"split edges", got, run("ref"), kind)
        if got[3:].count_nonzero() != 0:
            fail("decode_attention: a slot with no attendable key is not "
                 "zero")
    return outs


def check_decode(res: Results, rng, dev, H, K, Dh, L, edges=True):
    """decode_attention against its plain version at the ring serving
    path's shape (4 slots, L=1024; bf16 timed L2-cold, f32 windowed) and,
    with ``edges``, at the kernel's split edges: t = split - 1, split,
    split + 1, a slot whose every key is masked and an inactive slot (no
    position written), the last two exact zeros. Returns the outputs."""
    import torch
    from repro_torch.kernels import ops
    outs = check_decode_edges(res, rng, dev, H, K, Dh, L) if edges else {}
    B = 4
    t = np.asarray([63, 300, L - 1, L + 476], np.int32)   # last one wrapped
    cases = [("bf16", 0, True), ("f32", 256, False)]      # (dtype, window)
    for kind, window, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pos_np, valid_np = _ring(rng, B, L, t, 0.8)
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        k = torch.randn(B, L, K, Dh, device=dev).to(dt)
        v = torch.randn(B, L, K, Dh, device=dev).to(dt)
        pos, valid = (torch.from_numpy(a).to(dev) for a in (pos_np, valid_np))
        tv = torch.from_numpy(t).to(dev)
        run = lambda backend=None: ops.decode_attention(
            q, k, v, pos, tv, valid, window=window, backend=backend)
        outs[kind] = run()
        res.compare("decode_attention", f"{kind} B={B} L={L} H={H} K={K} "
                    f"window={window} ring holes", outs[kind], run("ref"),
                    kind)
        if not timed:
            continue
        att = (pos_np >= 0) & (pos_np <= t[:, None]) & valid_np
        if window:
            att &= (t[:, None] - pos_np) < window
        esz = q.element_size()
        nbytes = (2 * q.numel() + 2 * int(att.sum()) * K * Dh) * esz \
            + pos.numel() * 4 + valid.numel() + B * 4
        # On the serving path every layer has its own ring cache, so decode
        # finds K/V cold in HBM. Time it that way: rotate over enough K/V
        # sets (same masks) that their total is twice the L2 cache.
        n_sets = 1 + 2 * L2_BYTES // (k.numel() * esz * 2)
        ks = [k] + [torch.randn_like(k) for _ in range(n_sets - 1)]
        vs = [v] + [torch.randn_like(v) for _ in range(n_sets - 1)]
        mask = torch.from_numpy(att).to(dev)[:, None, None, :]
        dec = lambda backend: cycling(lambda i: ops.decode_attention(
            q, ks[i], vs[i], pos, tv, valid, window=window,
            backend=backend), n_sets)
        print(f"  decode_attention  timed L2-cold: rotating over {n_sets} "
              f"K/V sets ({mib(ks + vs):.0f} MiB)")
        res.timing("decode_attention", device_and_eager_ms(dec(None), 50),
                   device_and_eager_ms(dec("ref"), 10),
                   4 * Dh * H * float(att.sum()), nbytes, kind,
                   sdpa_ms("decode_attention", q.transpose(1, 2), ks, vs,
                           mask, 50))
        del ks, vs
    return outs


PAGE_SIZE = 16                 # the JAX engine's default page size


def _paged_case(rng, B, N, ps, P):
    """Page-table rows for B slots of P entries over a pool of N pages (the
    last one the trash page), in shuffled pool order: row 0 mid-page with
    a -1 hole, row 1 full, row 2 all -1 (an inactive slot: exact zeros),
    row 3 at the first lane of a page. Returns (table, t)."""
    pages = iter(rng.permutation(N - 1))
    t = np.asarray([8 * ps + 4, P * ps - 1, 300, 16 * ps], np.int32)[:B]
    table = np.full((B, P), -1, np.int32)
    for b in (0, 1, 3):
        for p in range(int(t[b]) // ps + 1):
            table[b, p] = next(pages)
    table[0, 5] = -1
    return table, t


def paged_attendable(table, t, pvalid, lanes=False):
    """(R, P * ps) bool masks of one ``paged_decode_attention`` call's keys:
    attendable (entry >= 0, j <= t, pvalid of its page lane) and visited
    (entry >= 0, j <= t: the kernel reads their pvalid lanes), and with
    ``lanes`` each key's pool lane (page * ps + lane). Leading batch
    dimensions of table (R, P), t (R,) and pvalid (N, ps) carry over."""
    import torch
    ps, P = pvalid.shape[-1], table.shape[-1]
    j = torch.arange(P * ps, device=table.device)
    ent = table[..., j // ps].long()
    visited = (ent >= 0) & (j <= t[..., None])
    lane = ent.clamp(min=0) * ps + j % ps
    pv = pvalid.flatten(-2).gather(-1, lane.flatten(-2)).reshape(ent.shape)
    return (visited & pv, visited) + ((lane,) if lanes else ())


def paged_work(q, kp, table, t, pvalid):
    """(flops, bytes, attendable keys) of one ``paged_decode_attention`` call
    on this data: q and out, the attended K/V rows and the pvalid lanes of
    the visited keys, each once however many q rows share its page (the
    rows of a prefill chunk share all of theirs), the table and t.
    ``flops`` counts every (q row, attendable key) pair."""
    K, Dh = kp.shape[2], kp.shape[3]
    att, visited, lane = paged_attendable(table, t, pvalid, lanes=True)
    keys = int(att.sum())
    rows = lambda m: int(lane[m].unique().numel())
    nbytes = (2 * q.numel() + 2 * rows(att) * K * Dh) * q.element_size() \
        + table.numel() * 4 + t.numel() * 4 + rows(visited)
    return 4 * Dh * q.shape[2] * keys, nbytes, keys


def paged_cold(q, kp, vp, table, t, pvalid):
    """Kernel and plain times of one ``paged_decode_attention`` call,
    L2-cold: on the serving path every layer has its own pool, so rotate
    over enough pools (same table, t and pvalid) that their total is twice
    the L2 cache. Returns (kernel times, plain times, K pools, V pools),
    each time a (graphed, back-to-back) pair (``device_and_eager_ms``)."""
    import torch
    from repro_torch.kernels import ops
    n_sets = 1 + 2 * L2_BYTES // (kp.numel() * kp.element_size() * 2)
    kps = [kp] + [torch.randn_like(kp) for _ in range(n_sets - 1)]
    vps = [vp] + [torch.randn_like(vp) for _ in range(n_sets - 1)]
    dec = lambda backend: cycling(lambda i: ops.paged_decode_attention(
        q, kps[i], vps[i], table, t, pvalid, backend=backend), n_sets)
    print(f"  paged_decode_attention timed L2-cold: rotating over {n_sets} "
          f"pools ({mib(kps + vps):.0f} MiB)")
    return (device_and_eager_ms(dec(None), 50),
            device_and_eager_ms(dec("ref"), 10), kps, vps)


def check_paged_decode(res: Results, rng, dev, H, K, Dh, max_seq):
    """paged_decode_attention against its plain version at the paged
    serving path's shape (4 slots, page size 16, max_seq 1024: 64 entries
    per row, the ring-equivalent pool of 4 * 64 + 1 pages), bf16 and f32,
    with pvalid holes; timed L2-cold beside SDPA over the pre-gathered
    buffer and the gather alone."""
    import torch
    from repro_torch.kernels import ops
    B, ps = 4, PAGE_SIZE
    P = max_seq // ps
    N = B * P + 1
    table_np, t = _paged_case(rng, B, N, ps, P)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pvalid_np = rng.random((N, ps)) < 0.8
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        kp = torch.randn(N, ps, K, Dh, device=dev).to(dt)
        vp = torch.randn(N, ps, K, Dh, device=dev).to(dt)
        table, tv, pvalid = (torch.from_numpy(a).to(dev)
                             for a in (table_np, t, pvalid_np))
        run = lambda backend=None: ops.paged_decode_attention(
            q, kp, vp, table, tv, pvalid, backend=backend)
        outs[kind] = got = run()
        res.compare("paged_decode_attention", f"{kind} B={B} P={P} ps={ps} "
                    f"N={N} H={H} K={K} holes", got, run("ref"), kind)
        if got[2].count_nonzero() != 0:
            fail("paged_decode_attention: the all -1 row is not zero")
        if kind != "bf16":
            continue
        flops, nbytes, keys = paged_work(q, kp, table, tv, pvalid)
        print(f"  paged_decode_attention {keys} attendable keys of "
              f"{B * P * ps}")
        ms, plain, kps, vps = paged_cold(q, kp, vp, table, tv, pvalid)
        pid = table.clamp(min=0).long()
        gather = lambda i: (kps[i][pid].reshape(B, P * ps, K, Dh),
                            vps[i][pid].reshape(B, P * ps, K, Dh))
        kvs = [gather(i) for i in range(len(kps))]
        mask = paged_attendable(table, tv, pvalid)[0][:, None, None, :]
        res.timing("paged_decode_attention", ms, plain, flops, nbytes, kind,
                   sdpa_ms("paged_decode_attention", q.transpose(1, 2),
                           [k for k, _ in kvs], [v for _, v in kvs], mask,
                           50))
        g = cuda_ms(cycling(gather, len(kps)), 50)
        print(f"  paged_decode_attention beside it: the page gather alone "
              f"(K and V to (B, P*ps, K, Dh), what SDPA needs first) "
              f"{g[len(g) // 2]:.4f} ms [{g[0]:.4f}-{g[-1]:.4f}]")
        del kps, vps, kvs
    return outs


class PathCalls:
    """Records what decides the work of every call to the kernel wrappers
    ``names`` (default all of ``DATA``) made while active: each tensor
    operand's shape and dtype, copies of the operands that ``DATA`` names
    (masks, positions, page tables, counts; the caches change after the
    call), and the other arguments. The model calls the kernels through
    the ``ops`` module, so a delegating wrapper put there sees each call;
    the kernel wrappers and their launch counts are untouched. A captured
    graph's replay calls no wrapper: record a ``cuda_graphs=False``
    engine."""

    DATA = {"flash_attention": ("kv_valid", "kv_count"),
            "decode_attention": ("kv_pos", "t", "kv_valid"),
            "fused_mlp": ("token_weights", "valid_count"),
            "fused_mlp_routed": ("idx", "token_weights", "valid_count"),
            "paged_decode_attention": ("table", "t", "pvalid"),
            "moe_gmm": ("group_counts",)}
    # the kernels check_path_calls replays (the others have their own)
    REPLAYED = ("flash_attention", "decode_attention", "fused_mlp")

    def __init__(self, *names):
        self.names = names or tuple(self.DATA)

    def __enter__(self):
        import inspect
        import torch
        from repro_torch.kernels import ops
        self.calls, self._ops, self._orig = {}, ops, {}
        for name in self.names:
            orig = self._orig[name] = getattr(ops, name)
            sig = inspect.signature(orig)

            def record(*a, _name=name, _orig=orig, _sig=sig,
                       _data=self.DATA[name], **kw):
                args = _sig.bind(*a, **kw).arguments
                rec = {}
                for k, v in args.items():
                    if not isinstance(v, torch.Tensor):
                        rec[k] = v
                    elif k in _data:
                        rec[k] = v.detach().clone()
                    else:
                        rec[k] = ("shape", tuple(v.shape), v.dtype)
                self.calls.setdefault(_name, []).append(rec)
                return _orig(*a, **kw)
            setattr(ops, name, record)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self._ops, name, orig)

    @staticmethod
    def _work(name, c):
        """A call's work on its data: attendable (query, key) pairs for
        the attention kernels, rows for the MLP."""
        import torch
        if name == "flash_attention":
            B, S = c["q"][1][:2]
            valid = c.get("kv_valid")
            dev = valid.device if valid is not None else None
            valid = torch.ones(B, S, dtype=torch.bool, device=dev) \
                if valid is None else valid.expand(B, S)
            cnt = c.get("kv_count")
            cnt = torch.full((B,), S, device=dev) if cnt is None else \
                torch.as_tensor(cnt, device=dev).expand(B)
            return int(_attention_mask(B, S, valid, c.get("causal", True),
                                       cnt).sum())
        if name == "decode_attention":
            pos, t = c["kv_pos"], c["t"].reshape(-1, 1)
            att = (pos >= 0) & (pos <= t)
            if c.get("kv_valid") is not None:
                att &= c["kv_valid"]
            return int(att.sum())
        if name == "fused_mlp_routed":      # the selected rows
            B, Kb = c["idx"].shape
            cnt = c.get("valid_count")
            return B * Kb if cnt is None else int(
                torch.as_tensor(cnt).clamp(0, Kb).expand(B).sum())
        return int(np.prod(c["x"][1][:-1]))

    def heaviest(self):
        """The call of each of ``REPLAYED`` with the most work on its
        data."""
        return {name: max(cs, key=lambda c: self._work(name, c))
                for name, cs in self.calls.items() if name in self.REPLAYED}

    def paged_cases(self, chunk=256):
        """The heaviest ``paged_decode_attention`` call (most attendable
        keys) of each (q, pool) shape as (q shape, pool shape, table, t,
        pvalid, calls of that shape), the most q rows first."""
        import torch
        groups = {}
        for c in self.calls.get("paged_decode_attention", []):
            groups.setdefault((c["q"][1], c["kp"][1]), []).append(
                (c["table"], c["t"].reshape(-1), c["pvalid"]))
        out = []
        for (qs, ks), cs in groups.items():
            keys = torch.cat([paged_attendable(
                *(torch.stack([c[i] for c in cs[j:j + chunk]])
                  for i in range(3)))[0].sum((1, 2))
                for j in range(0, len(cs), chunk)])
            out.append((qs, ks, *cs[int(keys.argmax())], len(cs)))
        return sorted(out, key=lambda c: -c[0][0])

    def gmm_cases(self):
        """The heaviest ``moe_gmm`` call (most dispatched rows) of each
        distinct shape as (shape, (B, E) numpy counts), the largest shape
        first."""
        best = {}
        for c in self.calls.get("moe_gmm", []):
            shape = c["x"][1]
            cnt = c["group_counts"].cpu().numpy().reshape(shape[0], shape[1])
            if shape not in best or cnt.sum() > best[shape].sum():
                best[shape] = cnt
        return sorted(best.items(), key=lambda kv: (-np.prod(kv[0]),
                                                    -kv[1].sum()))


def check_paged_calls(res: Results, dev, cases, labels):
    """Replays the paged serving path's own ``paged_decode_attention``
    calls: the heaviest of each shape (a decode step's slot rows, a prefill
    chunk's rows: one table row repeated, t = pos0 + i) with its recorded
    table, t and pvalid and a random q and pool, in bf16 and f32, against
    the plain version; a row with no attendable key must be exact zeros.
    Each is timed L2-cold in bf16 beside its bound (printed; the kernel's
    row keeps check_paged_decode's time)."""
    import torch
    from repro_torch.kernels import ops
    for qs, ks, table, t, pvalid, n in cases:
        label = labels.get(qs[0], f"{qs[0]}-row")
        dead = ~paged_attendable(table, t, pvalid)[0].any(1)
        for kind in ("bf16", "f32"):
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            q = torch.randn(qs, device=dev).to(dt)
            kp = torch.randn(ks, device=dev).to(dt)
            vp = torch.randn(ks, device=dev).to(dt)
            run = lambda backend=None: ops.paged_decode_attention(
                q, kp, vp, table, t, pvalid, backend=backend)
            got = run()
            res.compare("paged_decode_attention", f"{kind} path {label} "
                        f"q {qs[0]} rows, t {int(t.min())}-{int(t.max())}",
                        got, run("ref"), kind)
            if got[dead].count_nonzero() != 0:
                fail(f"paged_decode_attention, the path's {label} call: a "
                     f"row with no attendable key is not zero")
            if kind != "bf16":
                continue
            flops, nbytes, keys = paged_work(q, kp, table, t, pvalid)
            ms, plain, _, _ = paged_cold(q, kp, vp, table, t, pvalid)
            b, by = bound_ms(flops, nbytes, kind)
            med = lambda tt: " / ".join(
                f"{ts[len(ts) // 2]:.4f} ms [{ts[0]:.4f}-{ts[-1]:.4f}]"
                for ts in tt) + " (graphed / eager)"
            print(f"  paged_decode_attention path {label}, heaviest of {n} "
                  f"calls ({keys} attendable keys, {int(dead.sum())} "
                  f"row(s) with none): kernel {med(ms)}  plain "
                  f"{med(plain)}  bound {b:.4f} ms ({by})")


def gmm_composite_ms(x, wi, wg, wo, counts, act):
    """(graphed, back-to-back) CUDA-event times of a cuBLAS bf16 composite
    of ``moe_gmm`` without routing weights: a zeroed output, then for every
    live group its live slots through x@wi, x@wg, act*mul, h@wo on
    contiguous copies of the expert weights (copied before the timing).
    Several PyTorch calls per live group, not one: printed as a yardstick,
    never the row's library_ms; the graphed time is the device's (the
    back-to-back one is the host's cost of ~5 calls per group at 60
    experts)."""
    import torch.nn.functional as F
    f = F.silu if act == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    E = wi.shape[0]
    wic = [wi[e].contiguous() for e in range(E)]
    wgc = [wg[e].contiguous() for e in range(E)]
    woc = [wo[e].contiguous() for e in range(E)]
    live = [(b, e, int(c)) for (b, e), c in np.ndenumerate(counts) if c > 0]

    def run():
        out = x.new_zeros(x.shape)
        for b, e, c in live:
            xs = x[b, e, :c]
            out[b, e, :c] = (f(xs @ wgc[e]) * (xs @ wic[e])) @ woc[e]
        return out
    return device_and_eager_ms(run, 5)


def gmm_tile_rows_ms(main):
    """``main``'s graphed times (``cuda_ms``) and output with the
    tensor-core plan's tile rows forced to 64 and to 128 (``ops.mlp_plan``
    patched for the call; ``--gmm-tile-rows``): the measurement behind the
    plan's choice of tile rows for ``moe_gmm``."""
    from repro_torch.kernels import ops
    orig, got = ops.mlp_plan, {}
    try:
        for rows in (64, 128):
            ops.mlp_plan = lambda *a, rows=rows: orig(*a)._replace(rows=rows)
            got[rows] = (cuda_ms(main, 5, graph=True), main())
    finally:
        ops.mlp_plan = orig
    return got


def check_moe_gmm(res, dev, label, cases, weights_of, timed,
                  tile_rows=False):
    """Replays a path's own ``moe_gmm`` calls on the card: each recorded
    (shape, counts) with random x and routing weights and the layout's
    expert weights ``weights_of(dtype) -> (wi, wg, wo)`` (strided moefied
    views or contiguous native stacks), in bf16 and f32, with and without
    routing weights, against the plain version; every slot at or past its
    count must be exactly zero, and each output must repeat bit for bit.
    The heaviest call of the largest shape in bf16 without weights (the
    path's own call) is timed beside its bound and a cuBLAS per-expert
    composite (and, with ``tile_rows``, the tensor-core body at 64- and
    128-row tiles): ``timed`` makes it the row's timing, else it is kept in
    the row under cases[label]. Returns the outputs by case."""
    import torch
    from repro_torch.kernels import ops
    print(f"  moe_gmm {label}: {len(cases)} distinct call shapes, the "
          f"heaviest call of each replayed")
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        wi, wg, wo = weights_of(dt)
        Fe = wi.shape[-1]
        for ci, (shape, counts) in enumerate(cases):
            B, E, C, D = shape
            x = torch.randn(shape, device=dev).to(dt)
            cnt = torch.from_numpy(counts.astype(np.int32)).to(dev)
            live = torch.arange(C, device=dev) < cnt[..., None]
            plan = ops.mlp_plan(dt, B * E, C, D, Fe)
            for weighted in (False, True):
                rw = torch.rand(B, E, C, device=dev) if weighted else None
                run = lambda backend=None: ops.moe_gmm(
                    x, wi, wo, wg, rw, cnt, act="swiglu", backend=backend)
                got = run()
                case = (f"{kind} {label} {tuple(shape)} rows "
                        f"{int(counts.sum())} w={'y' if weighted else 'n'}")
                outs[case] = got
                res.compare("moe_gmm", case, got, run("ref"), kind)
                if got[~live].count_nonzero() != 0:
                    fail(f"moe_gmm {label} {kind} {shape}: a slot past its "
                         f"count is not zero")
                if not torch.equal(got, run()):
                    fail(f"moe_gmm {label} {kind} {shape}: a repeat gives "
                         f"other bits")
            if kind == "bf16":
                lv = counts[counts > 0]
                print(f"  moe_gmm           {label} {tuple(shape)}: plan "
                      f"{tuple(plan)}; counts sum {int(counts.sum())}, "
                      f"{int((counts == 0).sum())} empty group(s), live "
                      f"groups' counts min / median / max {int(lv.min())} / "
                      f"{int(np.median(lv))} / {int(lv.max())}; "
                      f"{int((~live).sum())} slots past their counts: all "
                      f"exactly zero; repeats bit-identical")
            if kind != "bf16" or ci != 0:
                continue
            rows = int(counts.sum())
            live_e = int((counts.sum(0) > 0).sum())
            # the live experts' weights once, the dispatched rows of x, the
            # whole (B, E, C, D) output and the counts
            nbytes = (3 * D * Fe * live_e + rows * D + x.numel()) \
                * x.element_size() + B * E * 4
            main = lambda backend=None: ops.moe_gmm(     # no weights
                x, wi, wo, wg, None, cnt, act="swiglu", backend=backend)
            args = (device_and_eager_ms(main, 5),
                    cuda_ms(lambda: main("ref"), 3), 6 * D * Fe * rows,
                    nbytes, kind, None)
            comp = gmm_composite_ms(x, wi, wg, wo, counts, "swiglu")
            tiles = gmm_tile_rows_ms(main) if tile_rows and \
                plan.body == "wgmma" else {}
            med = lambda ts: ts[len(ts) // 2]
            print(f"  moe_gmm           {label}: cuBLAS bf16 per-expert "
                  f"composite (a yardstick, ~5 calls per live group) "
                  f"{med(comp[0]):.4f} ms graphed [{comp[0][0]:.4f}-"
                  f"{comp[0][-1]:.4f}], {med(comp[1]):.4f} ms eager")
            want = main()
            for r, (ts, o) in tiles.items():
                print(f"  moe_gmm           {label}: {r}-row tiles "
                      f"{med(ts):.4f} ms [{ts[0]:.4f}-{ts[-1]:.4f}] "
                      f"graphed; the "
                      f"same bits as the plan's {plan.rows}-row tiles: "
                      f"{torch.equal(o, want)}")
            extra = dict(shape=list(shape), rows=rows,
                         composite_ms=med(comp[1]),
                         graphed_composite_ms=med(comp[0]),
                         **{f"rows{r}_ms": med(ts)
                            for r, (ts, _) in tiles.items()})
            if timed:
                res.timing("moe_gmm", *args)
                res.rows["moe_gmm"].update(extra)
                continue
            b, by = bound_ms(*args[2:5])
            (graphed, eager), plain = args[:2]
            res.rows["moe_gmm"].setdefault("cases", {})[label] = dict(
                ms=med(eager), graphed_ms=med(graphed), plain_ms=med(plain),
                bound_ms=b, bound_by=by, **extra)
            print(f"  moe_gmm           {label} {tuple(shape)} median "
                  f"[min-max] of 5: kernel {med(graphed):.4f} ms "
                  f"[{graphed[0]:.4f}-{graphed[-1]:.4f}] graphed, "
                  f"{med(eager):.4f} ms [{eager[0]:.4f}-{eager[-1]:.4f}] "
                  f"eager  plain {med(plain):.4f} ms [{plain[0]:.4f}-"
                  f"{plain[-1]:.4f}]  bound {b:.4f} ms ({by})")
        del wi, wg, wo
    return outs


def moefied_weights(dev, D, F, E):
    """``weights_of`` for the moefied Qwen2-7B: random dense (D, F) / (F,
    D) matrices and their expert views (core/moefy.py, no copy)."""
    import torch
    from repro_torch.core.moefy import moefy_mlp

    def of(dt):
        w = lambda *sh: (torch.randn(*sh, device=dev) / sh[0] ** 0.5).to(dt)
        ep = moefy_mlp({"wi": w(D, F), "wg": w(D, F), "wo": w(F, D)}, E)
        return ep["wi"], ep["wg"], ep["wo"]
    return of


def native_weights(dev, cfg):
    """``weights_of`` for the native MoE: contiguous (E, D, Fe) / (E, Fe,
    D) expert stacks, as ``moe_init`` lays them out."""
    import torch
    E, D, Fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert

    def of(dt):
        w = lambda *sh: (torch.randn(*sh, device=dev) / sh[1] ** 0.5).to(dt)
        return w(E, D, Fe), w(E, D, Fe), w(E, Fe, D)
    return of


# ------------------------------- serving -------------------------------------

def serve(engine, requests, stagger: bool, after_step=None):
    """Submit two requests, step twice, submit the rest, run to the end.
    A request is (prompt, max_new_tokens, budget[, GenRequest kwargs]);
    ``after_step(handles)`` runs after every step. A graphed engine's
    ``compile_counts()`` is gated after the run (``check_counts``)."""
    from repro_torch.training import GenRequest
    first = 2 if stagger else len(requests)
    make = lambda r: GenRequest(r[0], r[1], budget=r[2],
                                **(r[3] if len(r) > 3 else {}))
    handles = [engine.submit(make(r)) for r in requests[:first]]

    def step():
        progressed = engine.step()
        if after_step is not None:
            after_step(handles)
        return progressed
    if stagger:
        for _ in range(2):
            step()
        handles += [engine.submit(make(r)) for r in requests[first:]]
    while not all(h.done for h in handles):
        if step() == 0:
            fail("serving engine stalled")
    if getattr(engine, "cuda_graphs", False):    # (--ab: an older tree's)
        check_counts(f"a graphed {engine.kv_layout} engine", engine)
    return [list(h.output) for h in handles]


def cache_tensors(tree):
    """Every tensor of a cache tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_tensors(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in cache_tensors(v)]
    return [tree]


def check_counts(label, engine):
    """Fails unless ``engine.compile_counts()`` is what a graphed engine
    builds whatever its budgets, slots and sampling settings: one chunk
    form on the paged layout (none on the ring: its admission is eager)
    and at most two decode forms, greedy-only and sampling."""
    counts = engine.compile_counts()
    paged = engine.kv_layout == "paged"
    if counts["prefill"] != int(paged) or not 1 <= counts["decode"] <= 2:
        fail(f"{label}: compile_counts {counts}, want prefill "
             f"{int(paged)} and decode 1 or 2")
    return counts


def engine_cache_tensors(engine):
    """``cache_tensors`` of an engine's caches; a paged pool's leaves
    without the trash page. That page is the sink of the writes no live
    page may take (inactive slots, tokens a router skipped, a shared final
    chunk): several slots write one lane of it in one scatter, in no fixed
    order, so its content is unspecified. Nothing reads it: the paged
    kernel reads only the pages of a slot's table row, and this fails
    unless the trash page is out of every table row, every freelist and
    the refcounts (it was never allocated)."""
    import torch
    leaves = cache_tensors(engine._caches)
    if engine.kv_layout != "paged":
        return leaves
    pool = engine.pool
    trash = [pool.trash_page(r) for r in range(pool.n_replicas)]
    if np.isin(engine._table, trash).any() or \
            any(t in pool._ref for t in trash) or \
            any(t in free for free in pool._free for t in trash):
        fail("the trash page is in a page-table row, a freelist or the "
             "refcounts")
    keep = torch.ones(pool.n_pages, dtype=torch.bool, device=engine.device)
    keep[trash] = False
    return [x[keep] for x in leaves]


def check_twin(label, graphed, eager, got, want):
    """A graphed engine against its ``cuda_graphs=False`` twin after the
    same requests: the same tokens, every cache (and pool) leaf (a pool
    without its trash page, ``engine_cache_tensors``) and, paged, the same
    page table and pool stats, bit for bit; prints both engines'
    ``compile_counts()``."""
    import torch
    if not graphed.cuda_graphs or eager.cuda_graphs:
        fail(f"{label}: not a graphed engine and its eager twin")
    if got != want:
        fail(f"{label}: graphed tokens {got} != cuda_graphs=False {want}")
    for a, b in zip(engine_cache_tensors(graphed),
                    engine_cache_tensors(eager)):
        if not torch.equal(a, b):
            fail(f"{label}: a cache leaf of the graphed engine differs from "
                 f"its cuda_graphs=False twin's")
    what = "tokens, caches"
    if graphed.kv_layout == "paged":
        if not np.array_equal(graphed._table, eager._table) or \
                graphed.pool.stats() != eager.pool.stats():
            fail(f"{label}: page table or pool stats differ from the "
                 f"cuda_graphs=False twin's")
        what += " but the trash page, page table, pool stats"
    counts = check_counts(label, graphed)
    print(f"{label}: graphed == cuda_graphs=False twin, bit for bit "
          f"({what}): ok; compile_counts {counts} (twin "
          f"{eager.compile_counts()})")


def twins(label, mk, run, rec=None):
    """``mk(cuda_graphs)`` -> an engine, ``run(engine)`` -> its tokens:
    runs a graphed engine, then its ``cuda_graphs=False`` twin (inside
    ``rec``, a ``PathCalls`` or any context, when given: a replay calls no
    wrapper, so the path's kernel calls are recorded from the twin), and
    holds them equal (``check_twin``). Returns the graphed engine's
    tokens."""
    graphed = mk(True)
    got = run(graphed)
    eager = mk(False)
    with (rec or contextlib.nullcontext()):
        want = run(eager)
    check_twin(label, graphed, eager, got, want)
    return got


def reserved_over(fn, label, device_line):
    """``fn()`` after the allocator's cache is emptied: prints the device
    memory it reserved beyond what was in use before it (the peak; for a
    graphed engine's first run this includes its graph pool). Returns
    fn's result."""
    import torch
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r0 = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    print(f"{label}: {(torch.cuda.max_memory_reserved() - r0) / 1e6:.1f} MB "
          f"of device memory reserved over the run, peak "
          f"[{device_line}]")
    return out


def cut(params, n_layers):
    """The first ``n_layers`` layers of a param or router tree (the
    twins' reduced depth; no copy)."""
    return dict(params, layers=params["layers"][:n_layers])


TWIN_LAYERS = 4     # the depth of the graphed-vs-eager twins of later phases


def twin_depth(cfg) -> int:
    """The reduced twins' depth: ``TWIN_LAYERS``, or the served depth when
    that is less."""
    return min(TWIN_LAYERS, cfg.n_layers)


def print_timing(label, tm, device_line):
    print(f"{label} prefill: {tm['prefill_tokens']} tokens in "
          f"{tm['prefill_s'] * 1e3:.1f} ms = "
          f"{tm['prefill_tokens'] / tm['prefill_s']:.1f} tok/s [{device_line}]")
    print(f"{label} decode: {tm['decode_steps']} steps, {tm['decode_tokens']} "
          f"tokens in {tm['decode_s'] * 1e3:.1f} ms = "
          f"{tm['decode_s'] * 1e3 / tm['decode_steps']:.2f} ms/step, "
          f"{tm['decode_tokens'] / tm['decode_s']:.1f} tok/s [{device_line}]")


def print_device_time(prof, wall_s, top=8):
    """Kernel time on the device by name, from a torch.profiler run, beside
    the host wall time of the same window (device busy share)."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profiled window: wall {wall_s * 1e3:.1f} ms, kernels "
          f"{busy_ms:.1f} ms on the device ({100 * busy_ms / (wall_s * 1e3):.1f}"
          f" % busy, device-activity profiler on)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  "
              f"{e.key[:100]}")


def profiled(fn, top=8):
    """``fn()`` under torch.profiler, device activity only (host op
    recording would slow the host-bound paths several times); prints the
    device kernel time by name beside the wall time of the window. Returns
    fn's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    print_device_time(prof, time.perf_counter() - t0, top=top)
    return out


def check_serving(args, dev, device_line, spec):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine

    full = get_config("qwen2-7b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    # the weights cover the deeper of the serving and training depths;
    # serving runs the first --layers of them
    init_cfg = dataclasses.replace(
        full, n_layers=max(args.layers, args.train_layers))
    print(f"model: {cfg.name} d={cfg.d_model} H={cfg.n_heads} K="
          f"{cfg.n_kv_heads} Dh={cfg.d_head} F={cfg.d_ff} V={cfg.vocab_size} "
          f"{cfg.dtype}, depth {cfg.n_layers} of {full.n_layers} layers"
          + ("" if cfg.n_layers == full.n_layers else " (depth cut)"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, init_cfg, spec, device=dev)
    rp = router_init(gen, init_cfg, spec, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for layer in params["layers"] for d in layer.values()
            for p in d.values()) + params["embed"].numel() + \
        params["lm_head"].numel()
    print(f"init: {n / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    lens = [64, 512, 200, 333, 128, 450]
    budgets = [1.0, 0.75, 0.5, 1.0, 0.5, 0.75]
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 16, b)
                for n, b in zip(lens, budgets)]
    mk = lambda mode, graphs=True: ServingEngine(
        params, rp, cfg, spec, mode=mode, batch_size=4, max_seq=1024,
        device=dev, cuda_graphs=graphs)

    engine = mk("infer")
    ops.reset_launch_counts()
    tokens = reserved_over(lambda: serve(engine, requests, stagger=True),
                           "ring infer, graphed (first run)",
                           device_line)               # the main path
    launches = ops.launch_counts()
    check_launches("serving", launches)
    first = dict(engine.timing)
    print_timing("main path (first run, cold)", first, device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    eager = mk("infer", graphs=False)
    check_twin(f"ring infer, {cfg.n_layers} layers", engine, eager, tokens,
               reserved_over(lambda: serve(eager, requests, stagger=True),
                             "ring infer, cuda_graphs=False twin",
                             device_line))
    print_timing("ring infer, cuda_graphs=False twin (first run)",
                 eager.timing, device_line)
    graph_vs_eager({"ring graphed": engine, "ring eager": eager},
                   (requests[1][0], 16, 0.75), device_line)
    del eager

    base = mk("base")
    teacher = serve(base, requests, stagger=True)
    print_timing("teacher, mode='base' (warm)", base.timing, device_line)
    nt = twin_depth(cfg)
    cfg_t = dataclasses.replace(cfg, n_layers=nt)
    twins(f"ring teacher (mode='base'), {nt} layers",
          lambda g: ServingEngine(cut(params, nt), rp, cfg_t, spec,
                                  mode="base", batch_size=4, max_seq=1024,
                                  device=dev, cuda_graphs=g),
          lambda e: serve(e, requests, stagger=True))
    for i, b in enumerate(budgets):
        if b == 1.0 and tokens[i] != teacher[i]:
            fail(f"budget-1.0 request {i} differs from the teacher: "
                 f"{tokens[i]} vs {teacher[i]}")
    print("budget 1.0 == mode='base' teacher, bit for bit: ok "
          f"({sum(b == 1.0 for b in budgets)} requests; "
          f"{sum(tokens[i] != teacher[i] for i in range(6))} of 6 differ "
          f"from the teacher in all)")
    solo_i = 4                       # budget 0.5, admitted mid-decode
    solo = profiled(lambda: serve(mk("infer"), [requests[solo_i]],
                                  stagger=False))[0]
    if solo != tokens[solo_i]:
        fail(f"request {solo_i} alone {solo} != staggered {tokens[solo_i]}")
    print(f"staggered == solo (request {solo_i}, budget "
          f"{budgets[solo_i]}): ok")
    ring = {"tokens": tokens, "timing": first}
    return launches, params, rp, requests, teacher, ring


def decode_turns(engines, req, device_line):
    """Warm serving of one request on each of two engines (name -> engine)
    in turns (a b b a): decode ms per step and prefill tok/s from
    ``engine.timing``. Reported, not gated."""
    a, b = engines
    turns, rates = [], []
    for name in (a, b, b, a):
        tm = engines[name].timing
        tm.update(decode_s=0.0, decode_steps=0, prefill_s=0.0,
                  prefill_tokens=0)
        serve(engines[name], [req], stagger=False)
        turns.append(f"{name} {tm['decode_s'] * 1e3 / tm['decode_steps']:.2f}")
        rates.append(f"{name} {tm['prefill_tokens'] / tm['prefill_s']:.1f}")
    print(f"warm serving in turns, one request ({len(req[0])}-token prompt, "
          f"{req[1]} new tokens, budget {req[2]}): decode ms/step "
          f"{' / '.join(turns)}; prefill tok/s {' / '.join(rates)} "
          f"[{device_line}]")


def graph_vs_eager(engines, req, device_line):
    """A graphed engine and its ``cuda_graphs=False`` twin (name ->
    engine), both warm: decode ms/step and prefill tok/s in turns, then
    decode under the profiler (wall and device ms per step, the device's
    busy share, operations per step). Reported, not gated."""
    decode_turns(engines, req, device_line)
    decode_profile(engines, req)


def decode_profile(engines, req, prof_tokens=7):
    """The decode steps of a ``prof_tokens``-token request (``req``'s
    prompt and budget) on each of two engines, after the step that admits
    it (the prefill's token and one decode step), under torch.profiler,
    device activity only: wall and device time per step, device
    operations per step, and the operations whose count per step differs
    between the two. Reported, not gated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import GenRequest
    a, b = engines
    ops_by = {}
    for name, eng in engines.items():
        h = eng.submit(GenRequest(req[0], prof_tokens, budget=req[2]))
        eng.step()                   # admission (prefill), first decode step
        torch.cuda.synchronize()
        steps = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while not h.done:
                eng.step()
                steps += 1
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        ops_by[name] = {e.key: (e.count / steps,
                                e.self_device_time_total / 1e3 / steps)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA}
        busy = sum(t for _, t in ops_by[name].values())
        print(f"{name} decode under the profiler (device activity): "
              f"{steps} steps, {wall:.2f} ms/step wall, {busy:.2f} "
              f"ms/step on the device ({100 * busy / wall:.1f} % busy), "
              f"{sum(c for c, _ in ops_by[name].values()):.0f} device "
              f"operations per step")
    get = lambda n, k: ops_by[n].get(k, (0.0, 0.0))
    diff = sorted(set(ops_by[a]) | set(ops_by[b]),
                  key=lambda k: -abs(get(b, k)[0] - get(a, k)[0]))
    print(f"device operations per step, {b} minus {a} (count, ms):")
    for k in diff[:8]:
        dc = get(b, k)[0] - get(a, k)[0]
        if dc:
            print(f"  {dc:+6.0f}x {get(b, k)[1] - get(a, k)[1]:+7.3f} ms  "
                  f"{k[:90]}")


def check_paged_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring):
    """The paged serving path on the Qwen2-7B weights already on the card:
    the six staggered requests (their paged_decode_attention calls recorded
    and the heaviest decode and chunk call replayed against the plain
    version), a mode="base" paged engine, a solo run, warm decode in turns
    with a ring engine, prefix sharing, a fork and preemption. Returns the
    launches of the staggered run, and its tokens, timing and the paged
    teacher's tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)

    def mk(mode="infer", n_pages=args.pages, graphs=True):
        return ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=4,
                             max_seq=1024, device=dev, kv_layout="paged",
                             page_size=PAGE_SIZE, n_pages=n_pages,
                             cuda_graphs=graphs)

    def drained(eng, what):
        st = eng.paged_stats()
        if st["allocated"] != 0:
            fail(f"paged serving, {what}: {st['allocated']} pages still "
                 f"allocated after every request finished")
        return st

    engine = mk()
    st = engine.pool.stats()
    pool_mb = sum(t.numel() * t.element_size() for layer in
                  engine._caches["layers"] for t in layer["attn"].values())
    print(f"paged serving: {cfg.name} depth {cfg.n_layers}, page size "
          f"{PAGE_SIZE}, {engine.pool.n_pages} pages ({st['usable']} usable "
          f"+ trash), {pool_mb / 1e6:.1f} MB of pool over {cfg.n_layers} "
          f"layers [{device_line}]")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = reserved_over(lambda: serve(engine, requests, stagger=True),
                           "paged infer, graphed (first run)",
                           device_line)               # the main path
    launches = ops.launch_counts()
    check_launches("paged_serving", launches)
    first = dict(engine.timing)
    st = drained(engine, "staggered run")
    eager = mk(graphs=False)
    with PathCalls("paged_decode_attention") as rec:   # replays call none
        want = reserved_over(lambda: serve(eager, requests, stagger=True),
                             "paged infer, cuda_graphs=False twin",
                             device_line)
    check_twin(f"paged infer, {cfg.n_layers} layers", engine, eager, tokens,
               want)
    print_timing("paged infer, cuda_graphs=False twin (first run)",
                 eager.timing, device_line)
    print(f"paged_decode_attention at the paged serving path's calls "
          f"(recorded from the twin) [{device_line}]:")
    check_paged_calls(res, dev, rec.paged_cases(), {4: "decode step",
                                              PAGE_SIZE: "prefill chunk"})
    del rec
    print_timing("paged serving (first run)", first, device_line)
    print_timing("ring serving, same call (first run)", ring["timing"],
                 device_line)
    print(f"paged pool peak: {st['peak_allocated']} of {st['usable']} pages")
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    same = [i for i in range(len(tokens)) if tokens[i] == ring["tokens"][i]]
    agree = sum(a == b for i in range(len(tokens))
                for a, b in zip(tokens[i], ring["tokens"][i]))
    print(f"paged vs ring (reported, not gated: chunked and one-shot "
          f"prefills sum in other orders in bf16): {len(same)} of "
          f"{len(tokens)} requests identical, {agree} of "
          f"{sum(map(len, tokens))} tokens agree position by position")

    graph_vs_eager({"paged graphed": engine, "paged eager": eager},
                   (requests[1][0], 16, 0.75), device_line)
    del eager

    base = mk("base")
    teacher = serve(base, requests, stagger=True)
    drained(base, "teacher run")
    print_timing("paged teacher, mode='base' (warm)", base.timing,
                 device_line)
    nt = twin_depth(cfg)
    cfg_t = dataclasses.replace(cfg, n_layers=nt)
    twins(f"paged teacher (mode='base'), {nt} layers",
          lambda g: ServingEngine(cut(params, nt), rp, cfg_t, spec,
                                  mode="base", batch_size=4, max_seq=1024,
                                  device=dev, kv_layout="paged",
                                  page_size=PAGE_SIZE, cuda_graphs=g),
          lambda e: serve(e, requests, stagger=True))
    for i, (_, _, b) in enumerate(requests):
        if b == 1.0 and tokens[i] != teacher[i]:
            fail(f"paged: budget-1.0 request {i} differs from the paged "
                 f"teacher: {tokens[i]} vs {teacher[i]}")
    print("paged budget 1.0 == mode='base' paged teacher, bit for bit: ok")
    solo_i = 4
    solo_eng = mk()
    solo = profiled(lambda: serve(solo_eng, [requests[solo_i]],
                                  stagger=False))[0]
    drained(solo_eng, "solo run")
    if solo != tokens[solo_i]:
        fail(f"paged: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"paged staggered == solo (request {solo_i}): ok")
    ring_eng = ServingEngine(params, rp, cfg, spec, mode="infer",
                             batch_size=4, max_seq=1024, device=dev)
    engines = {"ring": ring_eng, "paged": mk()}
    decode_turns(engines, (requests[0][0], 16, 0.75), device_line)
    decode_profile(engines, (requests[0][0], 16, 0.75))
    del engines
    del ring_eng

    # prefix sharing: a common 256-token prefix = 16 full pages
    rng = np.random.default_rng(args.seed + 3)
    V = cfg.vocab_size
    pre = rng.integers(0, V, 256).astype(np.int32)
    pair = [np.concatenate([pre, rng.integers(0, V, 64).astype(np.int32)])
            for _ in range(2)]
    eng = mk()
    hs = [eng.submit(GenRequest(pair[0], 16, budget=0.75))]
    eng.step()
    hs.append(eng.submit(GenRequest(pair[1], 16, budget=0.75)))
    eng.step()
    shared = eng.paged_stats()["shared"]
    while not all(h.done for h in hs):
        if eng.step() == 0:
            fail("paged engine stalled (prefix sharing)")
    drained(eng, "prefix sharing")
    if shared != 256 // PAGE_SIZE:
        fail(f"prefix sharing: {shared} shared pages, want "
             f"{256 // PAGE_SIZE}")
    for i, h in enumerate(hs):
        alone = serve(mk(), [(pair[i], 16, 0.75)], stagger=False)[0]
        if list(h.output) != alone:
            fail(f"prefix sharing: request {i} {list(h.output)} != alone "
                 f"{alone}")
    print(f"prefix sharing: {shared} pages shared while both ran, each "
          f"request == alone bit for bit, pool drained: ok")

    # fork mid-decode (copy-on-write of the partial tail page)
    p, n, b = requests[2]
    eng = mk()
    hp = eng.submit(GenRequest(p, n, budget=b))
    for _ in range(6):
        eng.step()
    prefix = list(hp.output)
    t_fork = int(eng._t[hp.slot])
    hc = eng.fork(hp)
    while not (hp.done and hc.done):
        if eng.step() == 0:
            fail("paged engine stalled (fork)")
    drained(eng, "fork")
    indep = serve(mk(), [(np.concatenate([p, np.asarray(prefix, np.int32)]),
                          n - len(prefix), b)], stagger=False)[0]
    print(f"fork at position {t_fork} ({t_fork % PAGE_SIZE} lanes of the "
          f"tail page copied) after {len(prefix)} tokens: parent and child "
          f"completed, pool drained: ok; child == independent run of prompt "
          f"+ output (reported, not gated): {list(hc.output) == indep} "
          f"({sum(x == y for x, y in zip(hc.output, indep))} of {len(indep)} "
          f"tokens)")

    # preemption: two 512-token requests on a pool too small for both to
    # grow past their prompts (each needs 33 pages at full length)
    need = -(-(512 + 16) // PAGE_SIZE)
    small = 2 * need - 1 + 1                # one page short, plus trash
    p2 = rng.integers(0, V, 512).astype(np.int32)
    pre_reqs = [requests[1], (p2, 16, requests[1][2])]
    eng = mk(n_pages=small)
    hs = [eng.submit(GenRequest(p, n, budget=b)) for p, n, b in pre_reqs]
    steps = 0
    while not all(h.done for h in hs):
        if eng.step() == 0 or steps > 500:
            fail("paged engine stalled (preemption)")
        steps += 1
    drained(eng, "preemption")
    if eng.n_preempted < 1:
        fail(f"preemption: none on a {small}-page pool")
    alone = [tokens[1], serve(mk(), [pre_reqs[1]], stagger=False)[0]]
    print(f"preemption: {small}-page pool, {eng.n_preempted} preemption(s), "
          f"both requests completed, pool drained: ok; each == its "
          f"uninterrupted run (reported, not gated): "
          f"{[list(h.output) == a for h, a in zip(hs, alone)]}")
    check_chunked_prefill_f32(params, rp, spec, dev, requests[2][0])
    return launches, {"tokens": tokens, "timing": first,
                      "teacher": teacher}


def check_chunked_prefill_f32(params, rp, spec, dev, prompt, n_layers=2,
                              rel_tol=1e-3):
    """The chunked paged prefill against the one-shot ring prefill at
    Qwen2-7B full width, ``n_layers`` layers, f32, budget 0.5: the
    last-token logits of ``prompt`` must agree within ``rel_tol`` of their
    largest magnitude (the two paths sum attention and the projections in
    other orders). Separates rounding from a fault where the bf16 paths'
    tokens part."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy
    from repro_torch.models import paged_cache_init, prefill, \
        prefill_chunk_step
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    pol = ElasticPolicy.uniform(0.5, n_heads=cfg.n_heads).to(dev)
    plen, ps = len(prompt), PAGE_SIZE
    n_chunks = -(-plen // ps)
    with torch.no_grad():
        ring, _ = prefill(p32, r32, {"tokens": torch.as_tensor(
            prompt[None], device=dev)}, cfg, spec, mode="infer", policy=pol)
        caches = paged_cache_init(cfg, n_chunks + 1, ps, device=dev)
        row = torch.arange(n_chunks, dtype=torch.int32, device=dev)
        for c in range(n_chunks):
            ck = np.zeros((1, ps), np.int32)
            ck[0, :min(ps, plen - c * ps)] = prompt[c * ps:(c + 1) * ps]
            paged, caches = prefill_chunk_step(
                p32, r32, torch.as_tensor(ck, device=dev), caches, c, row,
                c * ps, plen, cfg, spec, mode="infer", policy=pol)
    diff = float((paged - ring).abs().max())
    scale = float(ring.abs().max())
    same = int(paged.argmax()) == int(ring.argmax())
    print(f"chunked paged prefill vs one-shot ring prefill, f32, qwen2-7b "
          f"width, {n_layers} layers, {plen} tokens, budget 0.5: last-token "
          f"logits max |diff| {diff:.3e} of max |logit| {scale:.3e} "
          f"(tolerance {rel_tol:g} of it); same argmax: {same}")
    if not diff <= rel_tol * scale:
        fail("the chunked paged prefill disagrees with the ring prefill in "
             "f32")


def check_launches(path, launches):
    print(f"{path} path launches: {launches}")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")


def expert_spec(spec):
    """The slice's spec with every dense MLP moefied into 8 routed experts."""
    import dataclasses
    return dataclasses.replace(spec, mlp_n_experts=8, expert_routed=True)


def check_expert_serving(args, dev, device_line, spec, params, requests,
                         teacher):
    """The serving path with the Qwen2-7B MLPs moefied into 8 routed
    experts: the dense weights already on the card (moefied views, no
    copy) and fresh routers; the same six staggered requests. Returns the
    launches and the routers."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import prefill, router_init
    from repro_torch.training import ServingEngine
    full = get_config("qwen2-7b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    espec = expert_spec(spec)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rp = router_init(gen, dataclasses.replace(
        full, n_layers=max(args.layers, args.train_layers)), espec, device=dev)
    print(f"expert serving: {cfg.name} depth {cfg.n_layers}, MLPs moefied "
          f"into {espec.mlp_n_experts} experts (views of the dense weights), "
          f"fresh routers [{device_line}]")
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), espec,
        mode="infer", batch_size=4, max_seq=1024, device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("expert_serving", launches)
    twins(f"moefied ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True))
    print_timing("expert serving (first run)", engine.timing, device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    solo_i = 4
    solo = profiled(lambda: serve(mk(), [requests[solo_i]], stagger=False))[0]
    if solo != tokens[solo_i]:
        fail(f"expert serving: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"expert serving staggered == solo (request {solo_i}, budget "
          f"{requests[solo_i][2]}): ok")
    # budget 1.0 against the teacher: E partial products in bf16, so
    # reported, not gated
    full_ids = [i for i, r in enumerate(requests) if r[2] == 1.0]
    same = sum(tokens[i] == teacher[i] for i in full_ids)
    pol = ElasticPolicy.uniform(1.0, n_heads=cfg.n_heads,
                                n_experts=espec.mlp_n_experts).to(dev)
    prompt = {"tokens": torch.as_tensor(requests[0][0][None], device=dev)}
    with torch.no_grad():
        ls, _ = prefill(params, rp, prompt, cfg, espec, mode="infer",
                        policy=pol)
        lt, _ = prefill(params, None, prompt, cfg, espec, mode="base")
    diff = float((ls.float() - lt.float()).abs().max())
    print(f"expert serving budget 1.0 vs the dense teacher (reported, not "
          f"gated): {same} of {len(full_ids)} budget-1.0 requests give the "
          f"teacher's tokens; last-token logits of request 0 "
          f"({len(requests[0][0])} tokens) differ by at most {diff:.4e} "
          f"(bf16)")
    return launches, rp


def _f32_cut(params, rp, n_layers):
    """The first ``n_layers`` layers (and embedding, head, final norm) of
    the model and routers, as f32 copies."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.float()
    p = cast({k: v for k, v in params.items() if k != "layers"})
    p["layers"] = cast(params["layers"][:n_layers])
    return p, {"layers": cast(rp["layers"][:n_layers])}


def check_gradients(params, rp, spec, dev, seed, n_layers=2, budget=0.5,
                    depth=None, rel_tol=2e-3):
    """Router gradients of one distillation loss at Qwen2-7B full width,
    ``n_layers`` layers, f32: the kernel path (backend "cuda") against the
    plain path (backend "ref") on the same batch and policy. A leaf passes
    when max |g_kernel - g_plain| <= rel_tol * max |g_plain|. A leaf whose
    kernel-path gradient is all zero while the plain one is not fails (the
    mark of a kernel whose autograd plumbing is missing). With expert
    routing, every expert routing decision must also be the same on both
    paths: which experts each token selects, and which (token, expert)
    pairs each expert's capacity keeps (``expert_decisions``). ``depth``
    sets the depth budget apart from ``budget`` (the other knobs); the
    bucket is solved with the spec, so depth composes into it, and with
    depth routing every depth router leaf must get a non-zero gradient on
    both paths."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    from repro_torch.data import LMDataPipeline
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.training import make_loss_fn
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    S, B = 512, 2
    # the budget on every knob directly: at 2 layers the FLOP solver would
    # cut far deeper (the embedding and LM head dominate the 2-layer model)
    pol = ElasticPolicy.uniform(budget, n_heads=cfg.n_heads,
                                n_experts=spec.mlp_n_experts)
    if depth is not None:
        pol = pol.replace(depth_capacity=depth)
    pol = pol.to(dev)
    bucket = ragged_bucket(pol, S, spec=spec)
    tokens = torch.from_numpy(LMDataPipeline(
        vocab=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=seed).batch_at(0)).to(dev)
    out, picks, depth_ids = {}, {}, {}
    for backend in ("cuda", "ref"):
        sp = dataclasses.replace(spec, kernel_backend=backend)
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          r32)
        with expert_decisions() as picks[backend]:
            loss, m = make_loss_fn(cfg, sp)(leaves, p32, {"tokens": tokens},
                                            pol, bucket)
        flat = tree_leaves(leaves)
        depth_ids[backend] = [i for i, t in enumerate(flat) if any(
            t is d for layer in leaves["layers"] if "depth" in layer
            for d in tree_leaves(layer["depth"]))]
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        out[backend] = (float(loss.detach()), float(m["sel_rate"]),
                        [torch.zeros_like(t) if g is None else g
                         for g, t in zip(gs, flat)])
        torch.cuda.synchronize()
    (lk, sk, gk), (lr_, sr, gr) = out["cuda"], out["ref"]
    label = ("experts" if spec.expert_routed else
             "depth" if spec.depth_routed else "dense")
    print(f"gradient check ({label}): qwen2-7b width, {n_layers} layers, f32,"
          f" B={B} S={S}, budget {budget}"
          + ("" if depth is None else f", depth {depth}")
          + f" (bucket {bucket}; without the spec "
          f"{ragged_bucket(pol, S)}): loss kernel "
          f"{lk:.6f} plain {lr_:.6f}, sel_rate {sk:.6f} / {sr:.6f}")
    if sk != sr:
        fail("the kernel and plain paths selected different tokens")
    if spec.expert_routed:
        (dk, ok), (dr, orr) = picks["cuda"].result(), picks["ref"].result()
        if not dk or len(dk) != len(dr) or not all(
                torch.equal(a, b) for a, b in zip(dk, dr)):
            fail("the kernel and plain paths took different expert routing "
                 "decisions")
        moved = sum(int((a != b).sum()) for a, b in zip(ok, orr))
        print(f"  expert routing decisions of {len(dk) // 2} dispatches "
              f"(each token's experts, each expert's kept tokens) identical "
              f"on both paths: ok ({moved} kept tokens sit in another slot "
              f"of their expert's buffer: equal weights to f32 rounding, "
              f"the slot does not change a token's result)")
    if spec.depth_routed:
        ids = depth_ids["cuda"]
        if not ids or any(not bool(g[i].any()) for g in (gk, gr)
                          for i in ids):
            fail("a depth router leaf has no gradient")
        print(f"  all {len(ids)} depth router leaves get a non-zero "
              f"gradient on both paths: ok")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gk, gr)):
        scale = float(b.abs().max())
        if scale > 0 and float(a.abs().max()) == 0.0:
            fail(f"router leaf {i}: all-zero gradient on the kernel path, "
                 f"non-zero on the plain path")
        rel = float((a - b).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if rel > rel_tol:
            fail(f"router leaf {i}: kernel vs plain gradient {rel:.3e} of "
                 f"its largest element (tolerance {rel_tol:g})")
    print(f"  {len(gk)} router leaves: worst max|g_kernel - g_plain| / "
          f"max|g_plain| = {worst:.3e} (tolerance {rel_tol:g}); no leaf "
          f"zero on one path only: ok")


class expert_decisions:
    """Context manager that records the expert routing decisions of every
    ``models.moe.moe_apply`` chunk run inside it: per chunk, the
    (B, s, E) experts each token selected (the combine's finite top-k) and
    the (B, E, s) tokens each expert's capacity kept (the dispatch's first
    ``count`` slots). ``result()``: (decisions, slot orders)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []
        self.real = (moe._top, moe._expert_ffn)

        def top(scores, k):
            v, i = self.real[0](scores, k)
            self.calls.append(("top", v, i))
            return v, i

        def ffn(p, x_sel, act, backend=None, counts=None):
            self.calls.append(("ffn", counts))
            return self.real[1](p, x_sel, act, backend=backend, counts=counts)

        moe._top, moe._expert_ffn = top, ffn
        return self

    def __exit__(self, *exc):
        self.moe._top, self.moe._expert_ffn = self.real
        return False

    def result(self):
        import torch
        decisions, orders = [], []
        calls = iter(self.calls)
        for (_, dv, di), (_, cnt), (_, cv, ci) in zip(calls, calls, calls):
            B, E, C = di.shape
            s = cv.shape[1]
            slot = torch.arange(C, device=di.device)
            kept = torch.zeros(B, E, s, dtype=torch.bool, device=di.device)
            kept.scatter_(2, di, slot < cnt[..., None])
            sel = torch.zeros(B, s, E, dtype=torch.bool, device=ci.device)
            sel.scatter_(2, ci, torch.isfinite(cv))
            decisions += [sel, kept]
            orders.append(torch.where(slot < cnt[..., None], di, -1))
        return decisions, orders


def check_training(args, params, rp, spec, dev, device_line):
    """The training path: 4 steps at Qwen2-7B full width, --train-layers
    deep, bf16, through launch.train's build_trainer and step function.
    Returns the kernels' launches during the 4 steps. With expert routing
    the budget-1.0 student sums E partial products, so its difference from
    the teacher is reported instead of held to 0. Every expert or depth
    router leaf must get a non-zero gradient in the repeated plan step;
    with depth routing the step is then timed over ``depth_training_grid``'s
    (depth, token) budgets."""
    import torch
    from repro_torch.core import routing as R
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import forward
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.training import make_loss_fn
    steps, S, B = 4, 512, 2
    n = args.train_layers
    experts = spec.expert_routed
    path = ("expert_training" if experts else
            "depth_training" if spec.depth_routed else "training")
    cfg, ecfg, params, state, step_fn, pipe = T.build_trainer(
        "qwen2-7b", lr=1e-4, total_steps=steps, seq_len=S, global_batch=B,
        seed=args.seed, ecfg=spec, device=dev, n_layers=n,
        params={**params, "layers": params["layers"][:n]},
        routers={"layers": rp["layers"][:n]})
    anneal = dict(budget=0.5, anneal_from=1.0, anneal_steps=3)
    policy_at = T.policy_schedule(cfg, ecfg, seq_len=S, total_steps=steps,
                                  device=dev, **anneal)
    budget_at = T.capacity_anneal(1.0, 0.5, 3)
    print(f"{path}: {cfg.name} width, depth {n} layers, {cfg.dtype}, "
          f"B={B} S={S}, AdamW on "
          f"{T.router_param_count(state.router_params)} router params, "
          f"remat, budget 1.0 -> 0.5 over 3 steps [{device_line}]")
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(i), device=dev)}
               for i in range(steps)]
    states = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i in range(steps):
        pol, bucket = policy_at(i)
        states.append(state)
        torch.cuda.reset_peak_memory_stats()
        timing = {}
        t0 = time.perf_counter()
        state, m = step_fn(state, params, batches[i], pol, bucket,
                           timing=timing)
        wall = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"training step {i}: non-finite metrics {m}")
        print(f"  step {i} budget {budget_at(i):.4f} "
              f"bucket {bucket}: loss {m['loss']:.6f} distill "
              f"{m['distill']:.6e} aux_load {m['aux_load']:.6f} aux_topk "
              f"{m['aux_topk']:.6f} sel_rate {m['sel_rate']:.4f} grad_norm "
              f"{m['grad_norm']:.6f} | teacher fwd "
              f"{timing['teacher_s'] * 1e3:.1f} ms, student fwd+bwd+update "
              f"{timing['student_s'] * 1e3:.1f} ms, step {wall * 1e3:.1f} ms "
              f"= {B * S / wall:.1f} tok/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"[{device_line}]")
        if i == 0 and (bucket != R.IDENTITY_BUCKET or (
                m["distill"] != 0.0 and not experts)):
            fail(f"budget-1.0 step: bucket {bucket}, distill {m['distill']}"
                 f" (want the identity bucket and exactly 0)")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(path, launches)

    # budget 1.0: the student's final hidden states are the teacher's
    pol, bucket = policy_at(0)
    with torch.no_grad():
        h_s, _ = forward(params, states[0].router_params, batches[0], cfg,
                         ecfg, mode="train", return_hidden=True, policy=pol,
                         bucket=bucket)
        h_t, _ = forward(params, None, batches[0], cfg, ecfg, mode="base",
                         return_hidden=True)
    if experts:
        print(f"budget 1.0 student vs mode='base' teacher hidden states "
              f"(reported, not gated: E partial products in bf16): max "
              f"|diff| {float((h_s.float() - h_t.float()).abs().max()):.4e}")
    elif not torch.equal(h_s, h_t):
        fail("budget-1.0 student hidden states differ from the teacher's")
    else:
        print("budget 1.0 student == mode='base' teacher hidden states, bit "
              "for bit; distill == 0.0 exactly: ok")

    # a plan step twice from the same state: the same bits
    i = steps - 1
    pol, bucket = policy_at(i)
    loss_fn = make_loss_fn(cfg, ecfg, remat=True)
    runs = []
    for _ in range(2):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          states[i].router_params)
        loss, _ = loss_fn(leaves, params, batches[i], pol, bucket)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        runs.append((loss.detach(), grads))
    kind = "expert" if experts else "depth" if spec.depth_routed else None
    if kind is not None:
        ids = {id(t) for layer in leaves["layers"]
               for t in tree_leaves(layer[kind])}
        dead = [j for j, (t, g) in enumerate(zip(flat, runs[0][1]))
                if id(t) in ids and (g is None or not bool(g.any()))]
        if dead or not ids:
            fail(f"{kind} router leaves without a gradient: {dead}")
        print(f"all {len(ids)} {kind} router leaves get a non-zero "
              f"gradient: ok")
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(runs[0][1], runs[1][1]))
    if not same:
        fail(f"plan step {i} (bucket {bucket}) run twice differs")
    print(f"plan step {i} (bucket {bucket}) twice from the same state: "
          f"loss and {len(runs[0][1])} router gradients bit-identical: ok")

    # where a plan step's time goes on the device
    print(f"plan step {i} under torch.profiler:")
    profiled(lambda: step_fn(states[i], params, batches[i], pol, bucket),
             top=12)
    if spec.depth_routed:
        depth_training_grid(step_fn, states[i], params, batches[0], cfg,
                            ecfg, dev, device_line, S)
    return launches


def check_native_serving(args, dev, device_line):
    """Qwen1.5-MoE-A2.7B at its published widths (qwen2-moe-a2.7b,
    --moe-layers deep, random bf16 weights from --seed) with its registered
    elastic config: expert top-k over the 60 experts, token routing, head
    top-k, LoRA. Five staggered requests of 64-512 tokens; the request
    admitted mid-decode alone must give its staggered tokens. Returns the
    launches and (params, routers, cfg, spec, requests) for the int8
    phase."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_elastic
    from repro_torch.core.policy import spec_from_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    full = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(full, n_layers=args.moe_layers)
    spec = spec_from_config(get_elastic("qwen2-moe-a2.7b", cfg))
    m = cfg.moe
    print(f"native MoE serving: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"K={cfg.n_kv_heads} Dh={cfg.d_head} experts {m.n_experts} top-"
          f"{m.top_k} d_expert {m.d_expert} shared {m.d_shared} "
          f"V={cfg.vocab_size} {cfg.dtype}, depth {cfg.n_layers} of "
          f"{full.n_layers} layers"
          + ("" if cfg.n_layers == full.n_layers else " (depth cut)"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.n_params() / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed + 2)
    lens = [64, 512, 200, 333, 128]
    budgets = [1.0, 0.75, 0.5, None, 0.5]
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 16, b)
                for n, b in zip(lens, budgets)]
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode="infer", batch_size=4, max_seq=1024, device=dev, cuda_graphs=g)
    engine = mk()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("native_serving", launches)
    twins(f"native MoE ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True))
    print_timing("native MoE serving (first run)", engine.timing,
                 device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")
    for solo_i in (3, 4):
        run = lambda: serve(mk(), [requests[solo_i]], stagger=False)
        solo = (profiled(run) if solo_i == 4 else run())[0]
        if solo != tokens[solo_i]:
            fail(f"native MoE: request {solo_i} alone {solo} != staggered "
                 f"{tokens[solo_i]}")
    print("native MoE staggered == solo (requests 3 and 4, budgets None and "
          "0.5): ok")
    return launches, (params, rp, cfg, spec, requests)


# ----------------------------- quantized serving ------------------------------
#
# The serving engine's kv_dtype / weight_dtype = "int8": K/V codes with f32
# scales per (key, kv-head) and weights with f32 scales per output channel
# (src/repro_torch/models/quant.py). Each kernel reads its int8 operands as
# int8; its bound counts them at 1 byte plus their f32 scales.

def int8_kv(k, v):
    """(k codes, v codes, k scales, v scales) of f32 K/V."""
    from repro_torch.models.quant import quantize_kv
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return kq, vq, ks, vs


def int8_weight(w):
    """(codes, scales) of an (.., in, out) weight, per output channel."""
    from repro_torch.models.quant import quantize_weight
    return quantize_weight(w.float(), (-2,))


def int8_timing(res, name, label, ms, plain, bf16_ms, flops, nbytes, kind):
    """Keeps an int8 case's times in the kernel's row under int8[label]:
    the kernel, its plain version and the same kernel on bf16 operands at
    the same shape (each a ``cuda_ms`` list, or a (graphed, back-to-back)
    pair), beside the bound; there is no single PyTorch call for an
    int8-operand function (library: none)."""
    b, by = bound_ms(flops, nbytes, kind)
    med = lambda ts: ts[len(ts) // 2]
    row = dict(bound_ms=b, bound_by=by, library_ms=None)
    text = []
    for key, ts in (("ms", ms), ("plain_ms", plain), ("bf16_ms", bf16_ms)):
        if isinstance(ts, tuple):
            row[key], row["graphed_" + key] = med(ts[1]), med(ts[0])
            text.append(f"{key[:-3] or 'kernel'} {med(ts[0]):.4f} ms "
                        f"[{ts[0][0]:.4f}-{ts[0][-1]:.4f}] graphed, "
                        f"{med(ts[1]):.4f} eager")
        else:
            row[key] = med(ts)
            text.append(f"{key[:-3] or 'kernel'} {med(ts):.4f} ms "
                        f"[{ts[0]:.4f}-{ts[-1]:.4f}]")
    res.rows[name].setdefault("int8", {})[label] = row
    print(f"  {name:17s} int8 {label} median [min-max] of 5: "
          f"{'; '.join(text)}; library: none; bound {b:.4f} ms ({by}, "
          f"int8 operands at 1 byte plus their f32 scales)")


def cold_sets(nbytes_one: int) -> int:
    """Operand sets to rotate over so that their total is twice the L2."""
    return 1 + 2 * L2_BYTES // max(nbytes_one, 1)


def check_int8_decode(res, rng, dev, H, K, Dh, L):
    """decode_attention with int8 K/V (kscale / vscale (B, L, K)) against
    its plain version at the ring serving path's shape (L = 1024), bf16
    and f32 queries: a wrapped ring, kv_valid holes, a slot whose every
    key is masked and an inactive slot (exact zeros); the bf16 call timed
    L2-cold beside the kernel on bf16 K/V at the same shape."""
    import torch
    from repro_torch.kernels import ops
    B = 5
    t = np.asarray([63, 300, L - 1, L + 476, 0], np.int32)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        pos_np, valid_np = _ring(rng, B, L, t, 0.8)
        valid_np[3] = False                    # every key of slot 3 masked
        pos_np[4] = -1                         # slot 4 inactive
        q = torch.randn(B, 1, H, Dh, device=dev).to(dt)
        k = torch.randn(B, L, K, Dh, device=dev)
        v = torch.randn(B, L, K, Dh, device=dev)
        kq, vq, ks, vs = int8_kv(k, v)
        pos, valid, tv = (torch.from_numpy(a).to(dev)
                          for a in (pos_np, valid_np, t))
        run = lambda backend=None: ops.decode_attention(
            q, kq, vq, pos, tv, valid, ks, vs, backend=backend)
        outs[kind] = got = run()
        res.compare("decode_attention", f"int8 K/V, {kind} q, B={B} L={L} "
                    f"holes, masked + inactive slot", got, run("ref"), kind)
        if got[3:].count_nonzero() != 0:
            fail("int8 decode_attention: a slot with no attendable key is "
                 "not zero")
        if kind != "bf16":
            continue
        att = (pos_np >= 0) & (pos_np <= t[:, None]) & valid_np
        rows = int(att.sum())
        nbytes = 2 * q.numel() * 2 + 2 * rows * K * (Dh + 4) \
            + pos.numel() * 4 + valid.numel() + B * 4
        n8 = cold_sets(2 * (kq.numel() + ks.numel() * 4))
        sets8 = [int8_kv(torch.randn_like(k), torch.randn_like(v))
                 for _ in range(n8 - 1)] + [(kq, vq, ks, vs)]
        n16 = cold_sets(2 * k.numel() * 2)
        sets16 = [(torch.randn_like(k).to(dt), torch.randn_like(v).to(dt))
                  for _ in range(n16)]
        call8 = lambda backend: cycling(lambda i: ops.decode_attention(
            q, sets8[i][0], sets8[i][1], pos, tv, valid, sets8[i][2],
            sets8[i][3], backend=backend), n8)
        call16 = cycling(lambda i: ops.decode_attention(
            q, sets16[i][0], sets16[i][1], pos, tv, valid), n16)
        print(f"  decode_attention  int8 timed L2-cold: {n8} int8 K/V sets "
              f"({mib([a for s in sets8 for a in s]):.0f} MiB), bf16 beside "
              f"it over {n16} ({mib([a for s in sets16 for a in s]):.0f} "
              f"MiB); {rows} attended rows of {B * L}")
        int8_timing(res, "decode_attention", f"ring ({B}, {L})",
                    device_and_eager_ms(call8(None), 50),
                    device_and_eager_ms(call8("ref"), 10),
                    device_and_eager_ms(call16, 50), 4 * Dh * H * rows,
                    nbytes, kind)
        del sets8, sets16
    return outs


def paged_int8_work(q, kp, table, t, pvalid):
    """``paged_work`` with int8 pools: each attended K/V row at 1 byte an
    element plus its f32 scale."""
    K, Dh = kp.shape[2], kp.shape[3]
    att, visited, lane = paged_attendable(table, t, pvalid, lanes=True)
    keys = int(att.sum())
    rows = lambda m: int(lane[m].unique().numel())
    nbytes = 2 * q.numel() * q.element_size() + 2 * rows(att) * K * (Dh + 4) \
        + table.numel() * 4 + t.numel() * 4 + rows(visited)
    return 4 * Dh * q.shape[2] * keys, nbytes, keys


def paged_int8_case(res, dev, label, qs, N, ps, K, Dh, table, t, pvalid,
                    timed):
    """One paged_decode_attention call shape with int8 pools against the
    plain version in bf16 and f32 (rows with no attendable key exact
    zeros); with ``timed`` the bf16 call L2-cold beside the kernel on bf16
    pools. Returns the outputs."""
    import torch
    from repro_torch.kernels import ops
    dead = ~paged_attendable(table, t, pvalid)[0].any(1)
    outs = {}
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q = torch.randn(qs, device=dev).to(dt)
        kp = torch.randn(N, ps, K, Dh, device=dev)
        vp = torch.randn(N, ps, K, Dh, device=dev)
        kq, vq, ks, vs = int8_kv(kp, vp)
        run = lambda backend=None: ops.paged_decode_attention(
            q, kq, vq, table, t, pvalid, ks, vs, backend=backend)
        outs[kind] = got = run()
        res.compare("paged_decode_attention", f"int8 pool, {kind} q, "
                    f"{label}", got, run("ref"), kind)
        if got[dead].count_nonzero() != 0:
            fail(f"int8 paged_decode_attention {label}: a row with no "
                 f"attendable key is not zero")
        if kind != "bf16" or not timed:
            continue
        flops, nbytes, keys = paged_int8_work(q, kq, table, t, pvalid)
        n8 = cold_sets(2 * (kq.numel() + ks.numel() * 4))
        sets8 = [int8_kv(torch.randn_like(kp), torch.randn_like(vp))
                 for _ in range(n8 - 1)] + [(kq, vq, ks, vs)]
        n16 = cold_sets(2 * kp.numel() * 2)
        sets16 = [(torch.randn_like(kp).to(dt), torch.randn_like(vp).to(dt))
                  for _ in range(n16)]
        call8 = lambda backend: cycling(lambda i: ops.paged_decode_attention(
            q, sets8[i][0], sets8[i][1], table, t, pvalid, sets8[i][2],
            sets8[i][3], backend=backend), n8)
        call16 = cycling(lambda i: ops.paged_decode_attention(
            q, sets16[i][0], sets16[i][1], table, t, pvalid), n16)
        print(f"  paged_decode_attention int8 {label}: {keys} attendable "
              f"keys; timed L2-cold over {n8} int8 pools, bf16 beside it "
              f"over {n16}")
        int8_timing(res, "paged_decode_attention", label,
                    device_and_eager_ms(call8(None), 50),
                    device_and_eager_ms(call8("ref"), 10),
                    device_and_eager_ms(call16, 50), flops, nbytes, kind)
        del sets8, sets16
    return outs


def check_int8_paged(res, rng, dev, H, K, Dh, max_seq):
    """paged_decode_attention with int8 pools and (N, ps, K) scale pools
    at the paged serving path's decode shape (``check_paged_decode``'s
    table: holes, an all -1 row, shuffled pages, pvalid holes)."""
    import torch
    B, ps = 4, PAGE_SIZE
    P = max_seq // ps
    N = B * P + 1
    table_np, t_np = _paged_case(rng, B, N, ps, P)
    table, t = (torch.from_numpy(a).to(dev) for a in (table_np, t_np))
    pvalid = torch.from_numpy(rng.random((N, ps)) < 0.8).to(dev)
    return paged_int8_case(res, dev, f"decode (4, {P}x{ps})", (B, 1, H, Dh),
                           N, ps, K, Dh, table, t, pvalid, timed=True)


def check_int8_mlp(res, dev, D, Fd):
    """fused_mlp with int8 weights and per-output-channel scales against
    its plain version: Qwen2-7B widths at the ring prefill's 512 rows and
    a paged chunk's 16 (bf16 x, timed beside the kernel on bf16 weights at
    the same shape), ragged counts with token weights (bf16, f32) and an
    ungated toy width (f32)."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, x shape, D, F, act, gated, token weights, counts, timed)
        ("bf16", (1, 512), D, Fd, "swiglu", True, False, None, "prefill"),
        ("bf16", (1, 16), D, Fd, "swiglu", True, False, None, "chunk"),
        ("bf16", (2, 77), D, Fd, "swiglu", True, True, [77, 30], None),
        ("f32", (2, 96), D, Fd, "swiglu", True, True, [96, 41], None),
        ("f32", (1, 70), 256, 512, "gelu", False, True, [70], None),
    ]
    outs = {}
    for kind, xs, d, f, act, gated, weighted, counts, timed in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = torch.randn(*xs, d, device=dev).to(dt)
        w = lambda a, b: torch.randn(a, b, device=dev) / a ** 0.5
        ws = [w(d, f), w(f, d)] + ([w(d, f)] if gated else [])
        (wi, wis), (wo, wos) = int8_weight(ws[0]), int8_weight(ws[1])
        wg, wgs = int8_weight(ws[2]) if gated else (None, None)
        tw = torch.rand(*xs, device=dev) if weighted else None
        cnt = None if counts is None else torch.tensor(counts, device=dev,
                                                       dtype=torch.int32)
        run = lambda backend=None: ops.fused_mlp(
            x, wi, wo, wg, tw, cnt, wis, wos, wgs, act=act, backend=backend)
        case = f"int8 weights, {kind} x={tuple(x.shape)} F={f} {act} " \
               f"cnt={counts}"
        outs[case] = got = run()
        res.compare("fused_mlp", case, got, run("ref"), kind)
        if not torch.equal(got, run()):
            fail(f"int8 fused_mlp {case}: a repeat gives other bits")
        if not timed:
            continue
        wb = [a.to(dt) for a in ws] + ([None] if not gated else [])
        bf16 = lambda: ops.fused_mlp(x, wb[0], wb[1], wb[2], tw, cnt,
                                     act=act)
        rows, n_mats = xs[0] * xs[1], len(ws)
        nbytes = n_mats * d * f + (2 * f + d) * 4 \
            + 2 * x.numel() * x.element_size()
        int8_timing(res, "fused_mlp", f"{timed} {tuple(xs)}", cuda_ms(run, 5),
                    cuda_ms(lambda: run("ref"), 3), cuda_ms(bf16, 5),
                    2 * rows * d * f * n_mats, nbytes, kind)
    return outs


def check_int8_gmm(res, dev, label, cases, cfg):
    """Replays an int8 expert path's own ``moe_gmm`` calls (recorded shapes
    and group counts) with native (E, D, Fe) / (E, Fe, D) int8 stacks and
    their (E, Fe) / (E, D) scales, random x, in bf16 and f32, with and
    without routing weights, against the plain version: slots past their
    count exact zeros, a repeat bit-identical. The heaviest call of the
    largest shape in bf16 timed beside the kernel on bf16 stacks."""
    import torch
    from repro_torch.kernels import ops
    E, D, Fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    w = lambda *sh: torch.randn(*sh, device=dev) / sh[1] ** 0.5
    wf = [w(E, D, Fe), w(E, D, Fe), w(E, Fe, D)]
    (wi, wis), (wg, wgs), (wo, wos) = (int8_weight(a) for a in wf)
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        for ci, (shape, counts) in enumerate(cases):
            B, E_, C, D_ = shape
            x = torch.randn(shape, device=dev).to(dt)
            cnt = torch.from_numpy(counts.astype(np.int32)).to(dev)
            live = torch.arange(C, device=dev) < cnt[..., None]
            for weighted in (False, True):
                rw = torch.rand(B, E, C, device=dev) if weighted else None
                run = lambda backend=None: ops.moe_gmm(
                    x, wi, wo, wg, rw, cnt, wis, wos, wgs, act="swiglu",
                    backend=backend)
                got = run()
                res.compare("moe_gmm", f"int8 stacks, {kind} {label} "
                            f"{tuple(shape)} rows {int(counts.sum())} "
                            f"w={'y' if weighted else 'n'}", got, run("ref"),
                            kind)
                if got[~live].count_nonzero() != 0:
                    fail(f"int8 moe_gmm {label}: a slot past its count is "
                         f"not zero")
                if not torch.equal(got, run()):
                    fail(f"int8 moe_gmm {label}: a repeat gives other bits")
            if kind != "bf16" or ci != 0:
                continue
            rows = int(counts.sum())
            live_e = int((counts.sum(0) > 0).sum())
            nbytes = 3 * D * Fe * live_e + live_e * (2 * Fe + D) * 4 \
                + (rows * D + x.numel()) * x.element_size() + B * E * 4
            wb = [a.to(dt) for a in wf]
            int8_timing(res, "moe_gmm", f"{label} {tuple(shape)}",
                        device_and_eager_ms(lambda: ops.moe_gmm(
                            x, wi, wo, wg, None, cnt, wis, wos, wgs), 5),
                        cuda_ms(lambda: ops.moe_gmm(
                            x, wi, wo, wg, None, cnt, wis, wos, wgs,
                            backend="ref"), 3),
                        device_and_eager_ms(lambda: ops.moe_gmm(
                            x, wb[0], wb[2], wb[1], None, cnt), 5),
                        6 * D * Fe * rows, nbytes, kind)
            del wb


def check_int8_path_calls(res, dev, label, rec):
    """Replays the heaviest int8 ``decode_attention`` and ``fused_mlp``
    call a quantized path made (its recorded positions, masks, counts) with
    random int8 operands and scales of its shapes, in bf16 and f32, against
    the plain version; a slot with no attendable key must be exact
    zeros."""
    import torch
    from repro_torch.kernels import ops
    for name, c in sorted(rec.heaviest().items()):
        work = PathCalls._work(name, c)
        for kind in ("bf16", "f32"):
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            if name == "decode_attention":
                kq, vq, ks, vs = int8_kv(torch.randn(c["k"][1], device=dev),
                                         torch.randn(c["v"][1], device=dev))
                q = torch.randn(c["q"][1], device=dev).to(dt)
                run = lambda backend=None: ops.decode_attention(
                    q, kq, vq, c["kv_pos"], c["t"], c["kv_valid"], ks, vs,
                    window=c.get("window", 0), backend=backend)
                shape = c["q"][1]
            else:
                x = torch.randn(c["x"][1], device=dev).to(dt)
                sh = lambda k: c[k][1]
                (wi, wis), (wo, wos) = (int8_weight(torch.randn(
                    sh(k), device=dev) / sh(k)[0] ** 0.5) for k in ("wi",
                                                                    "wo"))
                wg, wgs = int8_weight(torch.randn(
                    sh("wg"), device=dev) / sh("wg")[0] ** 0.5) \
                    if isinstance(c.get("wg"), tuple) else (None, None)
                run = lambda backend=None: ops.fused_mlp(
                    x, wi, wo, wg, c.get("token_weights"),
                    c.get("valid_count"), wis, wos, wgs,
                    act=c.get("act", "swiglu"), backend=backend)
                shape = c["x"][1]
            got = run()
            res.compare(name, f"int8 {kind} {label} path {tuple(shape)} "
                        f"({work} {'rows' if name == 'fused_mlp' else 'pairs'})",
                        got, run("ref"), kind)
            if name == "decode_attention":
                pos, t = c["kv_pos"], c["t"].reshape(-1, 1)
                dead = ~((pos >= 0) & (pos <= t) & c["kv_valid"]).any(-1)
                if got[dead].count_nonzero() != 0:
                    fail(f"int8 decode_attention, the {label} path's "
                         f"heaviest call: a slot with no attendable key is "
                         f"not zero")


def check_int8_paged_calls(res, dev, cases, labels):
    """The quantized paged path's heaviest ``paged_decode_attention`` call
    of each shape (a decode step, a prefill chunk), replayed with int8
    pools (``paged_int8_case``), the chunk timed."""
    for qs, ks, table, t, pvalid, n in cases:
        label = f"path {labels.get(qs[0], f'{qs[0]}-row')} (heaviest of {n})"
        paged_int8_case(res, dev, label, qs, ks[0], ks[1], ks[2], ks[3],
                        table, t, pvalid, timed=qs[0] == PAGE_SIZE)


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict / list."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def check_quant_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring, paged):
    """Qwen2-7B (``--layers`` deep) served with int8 weights and int8 K/V,
    ring then paged, on the bf16 weights already on the card (each engine
    quantizes them once at init): the six staggered requests; fails unless
    budget-1.0 rows equal an int8 mode="base" engine of the same layout, a
    request alone equals its staggered tokens, (paged) two requests
    sharing a 256-token prefix each equal their solo runs, the pool drains,
    and the int8 forms of fused_mlp, decode_attention (ring) and
    paged_decode_attention (paged) launched. The path's heaviest int8
    calls are replayed against the plain versions. Prints the rates beside
    the bf16 rows of the same call, the int8-vs-bf16 greedy agreement (not
    gated), the int8 engine's KV and weight bytes against the bf16
    engine's, and one warm decode profiled beside a bf16 engine. Returns
    the launches by path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    # the weights cover the training depth too: count the served layers
    served = dict(params, layers=params["layers"][:cfg.n_layers])

    def mk(mode="infer", layout="ring", dtype="int8", n_pages=args.pages,
           n_layers=cfg.n_layers, graphs=True):
        kw = dict(kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages) \
            if layout == "paged" else {}
        return ServingEngine(cut(served, n_layers), rp, dataclasses.replace(
            cfg, n_layers=n_layers), spec, mode=mode, batch_size=4,
            max_seq=1024, device=dev, kv_dtype=dtype, weight_dtype=dtype,
            cuda_graphs=graphs, **kw)

    launches = {}
    for layout, bf in (("ring", ring), ("paged", paged)):
        path = "quant_serving" if layout == "ring" else "quant_paged_serving"
        eng = mk(layout=layout)
        ref = mk(layout=layout, dtype="fp32")
        kv8, kv16 = tree_bytes(eng._caches), tree_bytes(ref._caches)
        w8, w16 = tree_bytes(eng.params), tree_bytes(ref.params)
        print(f"int8 {layout} serving: {cfg.name} depth {cfg.n_layers}, int8 "
              f"weights and K/V [{device_line}]: KV {kv8 / 1e6:.1f} MB "
              f"against bf16's {kv16 / 1e6:.1f} MB ({kv8 / kv16:.3f}x); "
              f"weights {w8 / 1e9:.3f} GB against {w16 / 1e9:.3f} GB "
              f"({w8 / w16:.3f}x)")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tokens = serve(eng, requests, stagger=True)   # the main path
        torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        check_launches(path, launches[path])
        if layout == "paged" and eng.paged_stats()["allocated"] != 0:
            fail("int8 paged serving: the pool did not drain")
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"bad generated tokens {toks}")
        rec = PathCalls(*(("fused_mlp", "paged_decode_attention")
                          if layout == "paged" else
                          ("fused_mlp", "decode_attention")))
        nt = twin_depth(cfg)
        twins(f"int8 {layout} infer, {nt} layers",
              lambda g: mk(layout=layout, n_layers=nt, graphs=g),
              lambda e: serve(e, requests, stagger=True), rec=rec)
        print(f"int8 {layout} kernel calls at the path's own shapes "
              f"(recorded from the {nt}-layer twin) "
              f"[{device_line}]:")
        check_int8_path_calls(res, dev, f"int8 {layout}", rec)
        if layout == "paged":
            check_int8_paged_calls(res, dev, rec.paged_cases(),
                                   {4: "decode step",
                                    PAGE_SIZE: "prefill chunk"})
        del rec
        print_timing(f"int8 {layout} serving (first run)", eng.timing,
                     device_line)
        print_timing(f"bf16 {layout} serving, same call (first run)",
                     bf["timing"], device_line)
        agree = sum(a == b for i in range(len(tokens))
                    for a, b in zip(tokens[i], bf["tokens"][i]))
        print(f"int8 vs bf16 greedy tokens (reported, not gated): "
              f"{sum(a == b for a, b in zip(tokens, bf['tokens']))} of "
              f"{len(tokens)} requests identical, {agree} of "
              f"{sum(map(len, tokens))} tokens agree position by position")
        base = mk("base", layout)
        teacher = serve(base, requests, stagger=True)
        if layout == "ring":    # for the train-mode phase
            bf.update(int8_teacher=teacher, int8_timing=dict(eng.timing))
        for i, (_, _, b) in enumerate(requests):
            if b == 1.0 and tokens[i] != teacher[i]:
                fail(f"int8 {layout}: budget-1.0 request {i} differs from "
                     f"the int8 teacher: {tokens[i]} vs {teacher[i]}")
        if layout == "paged" and base.paged_stats()["allocated"] != 0:
            fail("int8 paged teacher: the pool did not drain")
        del base
        solo = serve(mk(layout=layout), [requests[4]], stagger=False)[0]
        if solo != tokens[4]:
            fail(f"int8 {layout}: request 4 alone {solo} != staggered "
                 f"{tokens[4]}")
        print(f"int8 {layout}: budget 1.0 == int8 mode='base' teacher and "
              f"staggered == solo (request 4), bit for bit: ok")
        if layout == "paged":
            rng = np.random.default_rng(args.seed + 3)
            V = cfg.vocab_size
            pre = rng.integers(0, V, 256).astype(np.int32)
            pair = [np.concatenate([pre, rng.integers(0, V, 64).astype(
                np.int32)]) for _ in range(2)]
            sh = mk(layout="paged")
            hs = [sh.submit(GenRequest(pair[0], 16, budget=0.75))]
            sh.step()
            hs.append(sh.submit(GenRequest(pair[1], 16, budget=0.75)))
            sh.step()
            shared = sh.paged_stats()["shared"]
            while not all(h.done for h in hs):
                if sh.step() == 0:
                    fail("int8 paged engine stalled (prefix sharing)")
            if sh.paged_stats()["allocated"] != 0 or \
                    shared != 256 // PAGE_SIZE:
                fail(f"int8 prefix sharing: {shared} shared pages, "
                     f"{sh.paged_stats()['allocated']} left allocated")
            for i, h in enumerate(hs):
                alone = serve(mk(layout="paged"), [(pair[i], 16, 0.75)],
                              stagger=False)[0]
                if list(h.output) != alone:
                    fail(f"int8 prefix sharing: request {i} != alone")
            print(f"int8 prefix sharing: {shared} pages shared, each request "
                  f"== alone bit for bit, pool drained: ok")
            del sh
        decode_profile({f"bf16 {layout}": ref, f"int8 {layout}": eng},
                       (requests[0][0], 16, 0.75))
        del eng, ref
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def check_int8_fork_preemption(params, rp, spec, dev, seed, n_layers=2):
    """int8 weights and K/V on the paged pool, f32 at Qwen2-7B width,
    ``n_layers`` layers (a re-prefill then rounds as the decode steps it
    replaces, so a difference is a fault of the stored bytes): a fork
    child mid-page equals its independent run of prompt + output (the
    tail page's codes and scales copied verbatim), and two 512-token
    requests on a pool one page short (at least one preemption) each
    equal their uninterrupted runs, bit for bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.training import GenRequest, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    mk = lambda n_pages=None: ServingEngine(
        p32, r32, cfg, spec, mode="infer", batch_size=2, max_seq=1024,
        device=dev, kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages,
        kv_dtype="int8", weight_dtype="int8")
    rng = np.random.default_rng(seed + 6)
    p = rng.integers(0, cfg.vocab_size, 203).astype(np.int32)
    eng = mk()
    hp = eng.submit(GenRequest(p, 16, budget=0.75))
    for _ in range(4):
        eng.step()
    prefix = list(hp.output)
    t_fork = int(eng._t[hp.slot])
    hc = eng.fork(hp)
    while not (hp.done and hc.done):
        if eng.step() == 0:
            fail("int8 fork: engine stalled")
    indep = serve(mk(), [(np.concatenate([p, np.asarray(prefix, np.int32)]),
                          16 - len(prefix), 0.75)], stagger=False)[0]
    if list(hc.output) != indep or eng.paged_stats()["allocated"] != 0:
        fail(f"int8 fork at {t_fork}: child {list(hc.output)} != "
             f"independent {indep}")
    reqs = [(rng.integers(0, cfg.vocab_size, 512).astype(np.int32), 16, 0.75)
            for _ in range(2)]
    need = -(-(512 + 16) // PAGE_SIZE)
    eng = mk(2 * need)                  # one page short, plus the trash page
    got = serve(eng, reqs, stagger=False)
    if eng.n_preempted < 1:
        fail("int8 preemption: none on the short pool")
    alone = [serve(mk(), [r], stagger=False)[0] for r in reqs]
    if got != alone:
        fail(f"int8 preemption: {got} != uninterrupted {alone}")
    print(f"int8 fork (f32, {n_layers} layers, at position {t_fork}, "
          f"{t_fork % PAGE_SIZE} lanes of the tail page copied) == its "
          f"independent run; preemption ({2 * need}-page pool, "
          f"{eng.n_preempted} preemption(s)) == uninterrupted runs; bit for "
          f"bit: ok")


def admission_times(engine, requests, profile=False):
    """Serves ``requests`` (staggered) on ``engine`` and returns each
    admission's (prompt length, bucket, ms): the host time of its
    ``prefill_into_slot`` call between two synchronizations (the bucket
    None on an infer engine). ``profile``: each call also runs under
    torch.profiler (device activity only) and its row adds (device ms,
    kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profiler
    from repro_torch.training import serve as serve_mod
    real, out = serve_mod.prefill_into_slot, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profiler(activities=[ProfilerActivity.CUDA]) if profile
              else contextlib.nullcontext()) as prof:
            r = real(*a, **kw)
            torch.cuda.synchronize()
        row = (a[2]["tokens"].shape[1], kw.get("bucket"),
               (time.perf_counter() - t0) * 1e3)
        if profile:
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            row += (sum(e.self_device_time_total for e in kern) / 1e3,
                    sum(e.count for e in kern))
        out.append(row)
        return r
    serve_mod.prefill_into_slot = timed
    try:
        serve(engine, requests, stagger=True)
    finally:
        serve_mod.prefill_into_slot = real
    return out


def check_int8_routed_calls(res, dev, label, calls):
    """Replays every ``fused_mlp_routed`` call an int8 train-mode path made
    (its recorded gather indices, token weights and count, random bf16 x of
    its shape) on random int8 weights of its shapes with their scales,
    against the plain version: within TOL, rows outside the selection exact
    zeros. The heaviest call (most selected rows) is timed beside the same
    kernel on the bf16 weights the codes came from, at the same shape
    (``int8_timing``)."""
    import torch
    from repro_torch.kernels import ops
    c0 = calls[0]
    D, Fd = c0["wi"][1]
    w = lambda a, b: torch.randn(a, b, device=dev) / a ** 0.5
    wf = [w(D, Fd), w(Fd, D), w(D, Fd)]
    (wi, wis), (wo, wos), (wg, wgs) = (int8_weight(a) for a in wf)
    worst, zeros = 0.0, 0

    def runner(c, x, ws, scales, backend=None):
        return lambda backend=backend: ops.fused_mlp_routed(
            x, c["idx"], *ws, c.get("token_weights"), c.get("valid_count"),
            *scales, act=c.get("act", "swiglu"), backend=backend)
    for c in calls:
        x = torch.randn(c["x"][1], device=dev).to(torch.bfloat16)
        run = runner(c, x, (wi, wo, wg), (wis, wos, wgs))
        got = run()
        worst = max(worst, res.compare(
            "fused_mlp_routed", f"int8 {label} call {tuple(x.shape)}", got,
            run("ref"), "bf16", quiet=True))
        B, Kb = c["idx"].shape
        live = torch.zeros(x.shape[:2], dtype=torch.bool, device=dev)
        cnt = torch.as_tensor(c["valid_count"], device=dev).expand(B)
        for b in range(B):
            live[b, c["idx"][b, :int(cnt[b])]] = True
        if got[~live].count_nonzero() != 0:
            fail(f"int8 fused_mlp_routed, a {label} call: a row outside the "
                 f"selection is not zero")
        zeros += int((~live).sum())
    rows = [PathCalls._work("fused_mlp_routed", c) for c in calls]
    print(f"  fused_mlp_routed  int8 {label}: {len(calls)} calls replayed "
          f"(selected rows {min(rows)}-{max(rows)}, buckets "
          f"{sorted({c['idx'].shape[1] for c in calls})}), worst err/tol "
          f"{worst:.3f} (bf16 TOL), {zeros} unselected rows all exactly "
          f"zero: ok")
    c = max(calls, key=lambda c: PathCalls._work("fused_mlp_routed", c))
    x = torch.randn(c["x"][1], device=dev).to(torch.bfloat16)
    B, S, _ = x.shape
    Kb, n = c["idx"].shape[1], PathCalls._work("fused_mlp_routed", c)
    run = runner(c, x, (wi, wo, wg), (wis, wos, wgs))
    bf16 = runner(c, x, [a.to(torch.bfloat16) for a in wf], (None,) * 3)
    # each int8 weight once with its scales, the selected x rows, the whole
    # (B, S, D) delta, idx and token weights (4 bytes each) and the counts
    nbytes = 3 * D * Fd + (2 * Fd + D) * 4 + (n * D + B * S * D) * 2 \
        + B * Kb * 8 + B * 4
    int8_timing(res, "fused_mlp_routed", f"{label} ({B}, {S}) Kb={Kb}",
                cuda_ms(run, 5), cuda_ms(lambda: run("ref"), 3),
                cuda_ms(bf16, 5), 2 * n * D * Fd * 3, nbytes, "bf16")


def check_train_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring):
    """Qwen2-7B (``--layers`` deep) served by ``ServingEngine(mode="train")``
    on the ring: each admission routes by top-k into the request's ragged
    capacity bucket (the routed MLP through ``fused_mlp_routed``), decode
    is the threshold step. The six staggered requests in bf16, then with
    int8 weights and K/V (the routed kernel's int8 form); fails unless the
    tokens are in the vocabulary, budget-1.0 requests equal the teacher
    (the ring ``mode="base"`` run of item 3; for int8, item 3c's int8
    teacher), request 4 (budget 0.5) alone equals its staggered run, bit
    for bit, ``compile_counts()`` is {prefill 0, decode 1}, the graphed
    engine equals its ``cuda_graphs=False`` twin at ``twin_depth`` and the
    path's kernels launched. Every ``fused_mlp_routed`` call of the int8
    run is replayed against the plain version (``check_int8_routed_calls``).
    Prints each admission's bucket and time (warm) beside an infer engine's
    and both engines' rates. Returns the launches by path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    served = cut(params, cfg.n_layers)

    def mk(dtype, mode="train", n_layers=cfg.n_layers, graphs=True):
        return ServingEngine(cut(served, n_layers), rp, dataclasses.replace(
            cfg, n_layers=n_layers), spec, mode=mode, batch_size=4,
            max_seq=1024, device=dev, kv_dtype=dtype, weight_dtype=dtype,
            cuda_graphs=graphs)

    launches = {}
    for dtype, path in (("fp32", "train_serving"),
                        ("int8", "quant_train_serving")):
        label = "bf16" if dtype == "fp32" else "int8"
        teacher = ring["teacher" if dtype == "fp32" else "int8_teacher"]
        eng = mk(dtype)
        rec = PathCalls("fused_mlp_routed") if dtype == "int8" else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with (rec or contextlib.nullcontext()):
            tokens = serve(eng, requests, stagger=True)   # the main path
        torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        check_launches(path, launches[path])
        timing = dict(eng.timing)
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"train {label}: bad generated tokens {toks}")
        if eng.compile_counts() != {"prefill": 0, "decode": 1}:
            fail(f"train {label}: compile_counts {eng.compile_counts()}, "
                 f"want prefill 0, decode 1")
        for i, (_, _, b) in enumerate(requests):
            if b == 1.0 and tokens[i] != teacher[i]:
                fail(f"train {label}: budget-1.0 request {i} differs from "
                     f"the teacher: {tokens[i]} vs {teacher[i]}")
        solo = serve(mk(dtype), [requests[4]], stagger=False)[0]
        if solo != tokens[4]:
            fail(f"train {label}: request 4 alone {solo} != staggered "
                 f"{tokens[4]}")
        print(f"train {label} ring serving, {cfg.name} depth {cfg.n_layers} "
              f"[{device_line}]: budget 1.0 == the {label} mode='base' "
              f"teacher, staggered == solo (request 4), bit for bit; "
              f"compile_counts {eng.compile_counts()}; launches "
              f"{launches[path]}: ok")
        nt = twin_depth(cfg)
        twins(f"train {label} ring, {nt} layers",
              lambda g: mk(dtype, n_layers=nt, graphs=g),
              lambda e: serve(e, requests, stagger=True))
        if rec is not None:
            print(f"int8 fused_mlp_routed at the train-mode path's own calls "
                  f"(the {cfg.n_layers}-layer run's admissions) "
                  f"[{device_line}]:")
            check_int8_routed_calls(res, dev, "train admission",
                                    rec.calls["fused_mlp_routed"])
            del rec
        # warm: each admission's bucket and time beside an infer engine's
        train = admission_times(eng, requests)
        infer = mk(dtype, mode="infer")
        serve(infer, requests, stagger=True)            # its cold run
        inf = admission_times(infer, requests)
        print(f"train {label} admissions, warm, bucket and ms (tok/s) "
              f"against the {label} infer engine's [{device_line}]:")
        for (n, bucket, ms), (_, _, ims), r in zip(train, inf, requests):
            print(f"  prompt {n:4d} budget {r[2]}: bucket "
                  f"{'identity' if bucket == -1 else bucket} {ms:8.2f} ms "
                  f"({n / ms * 1e3:8.1f} tok/s); infer {ims:8.2f} ms "
                  f"({n / ims * 1e3:8.1f} tok/s)")
        (tms, tk), (ims, ik) = (
            admission_times(e, requests[1:2], profile=True)[0][3:]
            for e in (eng, infer))
        print(f"train {label} admission of request 1 ({len(requests[1][0])} "
              f"tokens, budget {requests[1][2]}) under the profiler: "
              f"{tms:.2f} device ms, {tk} kernels; infer {ims:.2f} device "
              f"ms, {ik} kernels [{device_line}]")
        print_timing(f"train {label} ring serving (first run)", timing,
                     device_line)
        print_timing(f"{label} ring infer serving, same call (first run)",
                     ring["timing" if dtype == "fp32" else "int8_timing"],
                     device_line)
        del eng, infer
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def check_native_int8_serving(dev, device_line, state):
    """The native MoE of ``check_native_serving`` (its weights, routers and
    requests) served with int8 weights and K/V: staggered == solo bit for
    bit, moe_gmm launched; prints the rates. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    params, rp, cfg, spec, requests = state
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode="infer", batch_size=4, max_seq=1024, device=dev,
        kv_dtype="int8", weight_dtype="int8", cuda_graphs=g)
    engine = mk()
    print(f"native MoE int8 serving: weights {tree_bytes(engine.params) / 1e9:.3f}"
          f" GB (bf16 {tree_bytes(params) / 1e9:.3f}), KV "
          f"{tree_bytes(engine._caches) / 1e6:.1f} MB [{device_line}]")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("quant_native_serving", launches)
    twins(f"native MoE int8 ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, requests, stagger=True))
    print_timing("native MoE int8 serving (first run)", engine.timing,
                 device_line)
    del engine
    solo = serve(mk(), [requests[4]], stagger=False)[0]
    if solo != tokens[4]:
        fail(f"native MoE int8: request 4 alone {solo} != staggered "
             f"{tokens[4]}")
    print("native MoE int8 staggered == solo (request 4), bit for bit: ok")
    return launches


# -------------------------- depth routing, sampling ---------------------------

def depth_spec(spec):
    """The slice's spec with the depth router (per-token whole-layer skip)."""
    import dataclasses
    return dataclasses.replace(spec, depth_routed=True)


def with_depth_routers(rp, dev, d_model, seed):
    """The slice's routers with a fresh seeded depth router in each layer."""
    import torch
    from repro_torch.core import routing as R
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"layers": [dict(layer, depth=R.token_router_init(
        gen, d_model, device=dev)) for layer in rp["layers"]]}


def check_path_calls(res: Results, dev, label, rec: PathCalls):
    """Replays the heaviest ``flash_attention``, ``decode_attention`` and
    ``fused_mlp`` call a path made with its recorded masks, positions and
    counts and random operands of its shapes, in bf16 and f32, against the
    plain version (within TOL); a query row or slot with no attendable key
    must give exact zeros."""
    import torch
    from repro_torch.kernels import ops
    for name, c in sorted(rec.heaviest().items()):
        work = PathCalls._work(name, c)
        for kind in ("bf16", "f32"):
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            rand = lambda key, scale=1.0: (
                torch.randn(c[key][1], device=dev) * scale).to(dt)
            args = {k: (rand(k) if isinstance(v, tuple) and v
                        and v[0] == "shape" else v) for k, v in c.items()}
            if name == "fused_mlp":         # weights at a 1/sqrt(fan-in) scale
                for k in ("wi", "wg", "wo"):
                    if isinstance(c.get(k), tuple):
                        args[k] = rand(k, c[k][1][0] ** -0.5)
            args.pop("backend", None)
            got = getattr(ops, name)(**args)
            want = getattr(ops, name)(**args, backend="ref")
            shape = tuple(c["q" if "q" in c else "x"][1])
            res.compare(name, f"{kind} {label} path {shape} ({work} "
                        f"{'rows' if name == 'fused_mlp' else 'pairs'})",
                        got, want, kind)
            if name == "fused_mlp":
                continue
            if name == "flash_attention":
                B, S = shape[:2]
                valid = c.get("kv_valid")
                valid = torch.ones(B, S, dtype=torch.bool, device=dev) \
                    if valid is None else valid.expand(B, S)
                cnt = torch.full((B,), S, device=dev)
                dead = ~_attention_mask(B, S, valid, True, cnt).any(-1)
            else:
                pos, t = c["kv_pos"], c["t"].reshape(-1, 1)
                dead = ~((pos >= 0) & (pos <= t) & c["kv_valid"]).any(-1)
            if got[dead].count_nonzero() != 0:
                fail(f"{name}, the {label} path's heaviest call: a row with "
                     f"no attendable key is not zero")
            if kind == "bf16":
                print(f"  {name:17s} {label} path: {int(dead.sum())} "
                      f"query row(s) with no attendable key, exact zeros")


def serve_holes(engine, requests):
    """``serve(stagger=True)`` that also reads, as each request finishes,
    the (position, layer) pairs whose K/V it did not write (a token the
    depth or the attention token router skipped at that layer): the ring's
    ``valid`` row of its slot, or the ``pvalid`` lanes of its pages,
    over the prompt and every generated token but the last (never
    written). Returns (tokens, [(holes, pairs)] per request)."""
    import torch
    paged = engine.kv_layout == "paged"
    rows = {}
    if paged:                    # the table row as the slot frees it
        real_free = engine._free_slot_pages

        def free(slot):
            rows[slot] = engine._table[slot].copy()
            real_free(slot)
        engine._free_slot_pages = free
    holes = {}

    def read(handles):
        for i, h in enumerate(handles):
            if not h.done or i in holes:
                continue
            n = len(h.request.prompt) + len(h.output) - 1
            j = np.arange(n)
            miss = 0
            for layer in engine._caches["layers"]:
                a = layer["attn"]
                if paged:
                    pages = torch.as_tensor(
                        rows[h.slot][j // engine.page_size].astype(np.int64),
                        device=engine.device)
                    lanes = torch.as_tensor(j % engine.page_size,
                                            device=engine.device)
                    kept = a["pvalid"][pages, lanes]
                else:
                    if not bool((a["pos"][h.slot, :n].cpu().numpy()
                                 == j).all()):
                        fail("depth serving: a ring row's positions are "
                             "not its request's")
                    kept = a["valid"][h.slot, :n]
                miss += int((~kept).sum())
            holes[i] = (miss, n * len(engine._caches["layers"]))

    tokens = serve(engine, requests, stagger=True, after_step=read)
    if paged:
        del engine._free_slot_pages
    return tokens, [holes[i] for i in range(len(tokens))]


class DepthPromptSkips:
    """While active, records per budget below 1 the share of (prompt
    token, layer) pairs the depth router alone skips at the ring engine's
    infer prefills (one request's whole prompt each, told apart by its
    length), read from the router's logits against the threshold of the
    serving engine's policy for the request's budget (a budget-1.0 row
    keeps every token)."""

    def __init__(self, rp, cfg, spec, requests):
        from repro_torch.core import routing as R
        from repro_torch.core.policy import solve_budget
        self._R, self._ids = R, {id(layer["depth"]) for layer in rp["layers"]}
        self._budget = {len(p): b for p, _, b in requests if b < 1.0}
        self._thr = {b: R.threshold_logit(float(
            solve_budget(cfg, spec, b, static=True).theta))
            for b in set(self._budget.values())}
        self.seen = []

    def __enter__(self):
        real = self._real = self._R.token_logits

        def token_logits(r, x):
            lg = real(r, x)
            b = self._budget.get(x.shape[1]) if x.dim() == 3 else None
            if id(r) in self._ids and b is not None:
                self.seen.append((b, (lg <= self._thr[b]).float().mean()))
            return lg
        self._R.token_logits = token_logits
        return self

    def __exit__(self, *exc):
        self._R.token_logits = self._real

    def shares(self):
        return {b: float(sum(v for bb, v in self.seen if bb == b))
                / sum(bb == b for bb, _ in self.seen)
                for b in sorted(set(self._thr), reverse=True)}


def check_depth_serving(args, res, dev, device_line, spec, params, rp,
                        requests, ring, paged):
    """The slice's serving path with the depth router added (fresh seeded
    depth routers beside the slice's routers), on the Qwen2-7B weights
    already on the card, ring and paged: the six staggered requests,
    budget-1.0 rows against the mode="base" runs of the ring and paged
    phases, one request alone, the pool drained, the path's kernel calls
    replayed against their plain versions. Prints the KV holes and the
    depth router's own skip share per budget, and the rates beside the
    slice's. Returns (launches by path, the depth routers)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    dspec = depth_spec(spec)
    rp_d = with_depth_routers(rp, dev, cfg.d_model, args.seed + 4)
    budgets = sorted({b for _, _, b in requests}, reverse=True)
    launches = {}
    for layout, prior in (("ring", ring), ("paged", paged)):
        path = "depth_serving" if layout == "ring" else "depth_paged_serving"
        kw = dict(kv_layout="paged", page_size=PAGE_SIZE,
                  n_pages=args.pages) if layout == "paged" else {}
        mk = lambda n=cfg.n_layers, g=True: ServingEngine(
            cut(params, n), rp_d, dataclasses.replace(cfg, n_layers=n),
            dspec, mode="infer", batch_size=4, max_seq=1024, device=dev,
            cuda_graphs=g, **kw)
        engine = mk()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        skips = DepthPromptSkips(rp_d, cfg, dspec, requests) \
            if layout == "ring" else None
        with (skips or contextlib.nullcontext()):
            tokens, holes = serve_holes(engine, requests)   # the main path
            torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        rec = PathCalls()
        twins(f"depth {layout} infer, {twin_depth(cfg)} layers",
              lambda g: mk(twin_depth(cfg), g),
              lambda e: serve(e, requests, stagger=True), rec=rec)
        check_launches(path, launches[path])
        print(f"{path}: {cfg.name} depth {cfg.n_layers}, the slice's spec "
              f"and routers plus a depth router per layer [{device_line}]")
        print_timing(f"depth {layout} serving (first run)", engine.timing,
                     device_line)
        print_timing(f"{layout} serving without depth, same call (first "
                     f"run)", prior["timing"], device_line)
        for toks in tokens:
            if len(toks) != 16 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                fail(f"bad generated tokens {toks}")
        for i, (_, _, b) in enumerate(requests):
            if b == 1.0 and tokens[i] != prior["teacher"][i]:
                fail(f"depth {layout}: budget-1.0 request {i} differs from "
                     f"the mode='base' teacher")
        print(f"depth {layout}: budget 1.0 == mode='base' teacher, bit for "
              f"bit: ok")
        solo_i = 4
        solo_eng = mk()
        solo = serve(solo_eng, [requests[solo_i]], stagger=False)[0]
        if solo != tokens[solo_i]:
            fail(f"depth {layout}: request {solo_i} alone {solo} != "
                 f"staggered {tokens[solo_i]}")
        print(f"depth {layout}: staggered == solo (request {solo_i}, budget "
              f"{requests[solo_i][2]}): ok")
        if layout == "ring":
            print("depth router alone, share of (prompt token, layer) pairs "
                  "skipped at the staggered run's prefills, by budget: "
                  + ", ".join(f"{b}: {100 * v:.2f} %"
                              for b, v in skips.shares().items())
                  + "; 1.0: 0 (full budget keeps every token)")
            decode_turns({"ring": ServingEngine(
                params, rp, cfg, spec, mode="infer", batch_size=4,
                max_seq=1024, device=dev), "depth ring": mk()},
                (requests[0][0], 8, 0.75), device_line)
        if layout == "paged":
            for eng, what in ((engine, "staggered"), (solo_eng, "solo")):
                if eng.paged_stats()["allocated"] != 0:
                    fail(f"depth paged serving, {what} run: the pool did "
                         f"not drain")
            print("depth paged: the pool drained after both runs: ok")
        share = {b: sum(h for (h, _), (_, _, bb) in zip(holes, requests)
                        if bb == b) / sum(n for (_, n), (_, _, bb) in
                                          zip(holes, requests) if bb == b)
                 for b in budgets}
        print(f"depth {layout}: (token, layer) pairs that wrote no K/V, by "
              f"budget (depth or attention token router; ring valid / "
              f"paged pvalid): " + ", ".join(f"{b}: {100 * s:.2f} %"
                                             for b, s in share.items()))
        print(f"depth kernel calls of the {layout} path (recorded from the "
              f"{twin_depth(cfg)}-layer twin) [{device_line}]:")
        check_path_calls(res, dev, f"depth {layout}", rec)
        if layout == "paged":
            check_paged_calls(res, dev, rec.paged_cases(),
                              {4: "depth decode step",
                               PAGE_SIZE: "depth prefill chunk"})
        del rec, engine, solo_eng
    return launches, rp_d


# --------------------- SLO controller, fault tolerance ------------------------

CTRL_N = 24            # requests in the controller phase's trace
CTRL_TICK_S = 0.02     # the injected clock's tick per engine step
CTRL_RATE = 4.0        # base arrivals per second of the trace (burst 4x)
CTRL_FAIL_STEP = 60    # the fault drill's failing step


def controller_trace(vocab, seed):
    """The controller phase's trace: ``CTRL_N`` requests from
    ``launch/workloads.make_requests`` (prompts 64-512 tokens and 16-64 new
    tokens, both heavy-tailed; classes interactive 0.75 / batch 0.25;
    request seeds 0-23), arrival times from ``bursty_times`` (the middle
    40 % at 4x ``CTRL_RATE``), and the classes' SLO targets: interactive
    p95 TTFT and ITL, batch shed first and with a queue deadline."""
    from repro_torch.launch import workloads as W
    from repro_torch.runtime.controller import SLOTarget
    reqs = W.make_requests(
        CTRL_N, vocab, prompt_lo=64, prompt_hi=512, max_new_lo=16,
        max_new_hi=64, class_mix={"interactive": 0.75, "batch": 0.25},
        seed=seed)
    arrive = W.bursty_times(np.random.default_rng(seed), CTRL_RATE, CTRL_N,
                            burst_factor=4, burst_frac=0.4)
    targets = {"interactive": SLOTarget(p95_ttft_ms=200.0,
                                        p95_itl_ms=2.5e3 * CTRL_TICK_S),
               "batch": SLOTarget(shed_order=1, deadline_ms=400.0)}
    return reqs, arrive, targets


def make_controller(targets):
    """The phase's ``SLOController``: floor 0.25 in steps of 0.25, one
    evaluation every two ticks, restore after two healthy evaluations."""
    from repro_torch.runtime.controller import SLOController
    return SLOController(targets=targets, floor=0.25, step_down=0.25,
                         step_up=0.25, window=16, min_samples=2,
                         eval_interval_s=2 * CTRL_TICK_S, hysteresis=0.7,
                         patience=2, queue_factor=0.5, escalate_after=4,
                         sample_ttl_s=0.5)


def run_controlled(engine, reqs, arrive, clock=None):
    """``launch/workloads.replay`` of the trace on ``engine`` (with a
    controller; ``clock``: the ``StepClock(CTRL_TICK_S)`` it was built
    with, ticked once per step, or None for the wall clock). A ring engine
    gets no fallback shape and a paged one (1, 1), so an escalation is
    declined on both (the paged engine cannot reshard). Records per step
    whether the
    controller was degraded when it began, the decode wall time and steps
    it added to ``engine.timing``, its ``compile_counts()`` after it and
    the controller's event count. Returns (handles, elapsed, replay info,
    the records)."""
    from repro_torch.launch.workloads import replay
    real, ctrl, rows = engine.step, engine.controller, []

    def step():
        degraded = min(ctrl.admission_budget, ctrl.depth_budget,
                       ctrl.inflight_budget) < 1.0
        tm = engine.timing
        d0, n0 = tm["decode_s"], tm["decode_steps"]
        n = real()
        rows.append((degraded, tm["decode_s"] - d0, tm["decode_steps"] - n0,
                     engine.compile_counts(), len(ctrl.events)))
        return n
    engine.step = step
    try:
        handles, elapsed, info = replay(
            engine, reqs, arrive, clock=clock,
            fallback_shapes=[(1, 1)] if engine.kv_layout == "paged" else ())
    finally:
        del engine.step
    return handles, elapsed, info, rows


def check_terminal(label, handles):
    """Every request reached a terminal state: served (``done``), shed
    (``rejected`` with a Retry-After hint) or expired
    (``deadline_exceeded``); no shed or expired request was prefilled.
    Returns (served, shed, expired)."""
    served = [h for h in handles if h.status == "done"]
    shed = [h for h in handles if h.finish_reason == "rejected"]
    expired = [h for h in handles if h.finish_reason == "deadline_exceeded"]
    if len(served) + len(shed) + len(expired) != len(handles):
        fail(f"{label}: a request did not reach a terminal state: "
             f"{[(h.status, h.finish_reason) for h in handles]}")
    for h in shed + expired:
        if h.status != "rejected" or h.t_first is not None or h.output:
            fail(f"{label}: a {h.finish_reason} request was prefilled or is "
                 f"not typed rejected")
    if any(h.retry_after is None for h in shed):
        fail(f"{label}: a shed request has no Retry-After hint")
    return served, shed, expired


def check_ladder(label, engine, handles, info, rows):
    """The gates of a controlled run on the injected clock: the events
    reach degrade_admission, degrade_depth, degrade_inflight and shed in
    that order and restore after the shed; shed requests are rejected with
    a Retry-After hint and expired ones deadline_exceeded, none prefilled,
    as the engine counted them; the controller escalated and
    ``maybe_escalate`` declined (``run_controlled``); ``compile_counts()``
    after the first degrade is what it is at the end. Prints the counts,
    the events and the served share."""
    ctrl = engine.controller
    kinds = [k for _t, k, _v in ctrl.events]
    ladder = ("degrade_admission", "degrade_depth", "degrade_inflight",
              "shed")
    missing = [k for k in ladder if k not in kinds]
    if missing:
        fail(f"{label}: the controller never reached {missing}: {kinds}")
    first = [kinds.index(k) for k in ladder]
    if first != sorted(first):
        fail(f"{label}: stages out of ladder order: {kinds}")
    if not any(k.startswith("restore_") for k in kinds[first[-1]:]):
        fail(f"{label}: no restore after the shed: {kinds}")
    served, shed, expired = check_terminal(label, handles)
    if not expired:
        fail(f"{label}: no request expired in the queue")
    if (engine.n_rejected, engine.n_expired) != (len(shed), len(expired)):
        fail(f"{label}: n_rejected / n_expired {engine.n_rejected} / "
             f"{engine.n_expired} != {len(shed)} / {len(expired)}")
    if "escalate" not in kinds or info["escalations"] or \
            engine.remeshed_at is not None:
        fail(f"{label}: no escalation, or maybe_escalate re-meshed "
             f"({info['escalations']} escalations)")
    at_degrade = next(r[3] for r in rows if r[4] > 0)
    if engine.compile_counts() != at_degrade:
        fail(f"{label}: compile_counts {engine.compile_counts()} grew after "
             f"the first degrade ({at_degrade})")
    print(f"{label}: {len(served)} served, {len(shed)} shed (rejected, "
          f"Retry-After {sorted({h.retry_after for h in shed})} s), "
          f"{len(expired)} expired in the queue, none prefilled; "
          f"{info['steps']} steps, queue peak {info['queue_peak']}; "
          f"compile_counts {at_degrade} at the first degrade and at the "
          f"end: ok")
    print(f"{label}: events " + ", ".join(
        f"{k}{'' if k in ('escalate',) else f' {v:g}'}@{t:.2f}s"
        for t, k, v in ctrl.events))
    return served, shed, expired


SPLIT_MIN_STEPS = 10   # steps on each side before degraded_ms compares


def degraded_ms(label, rows, device_line):
    """Mean decode wall ms per step over the steps that began degraded and
    over the others (steps that built a form left out); no comparison
    unless each side has ``SPLIT_MIN_STEPS`` steps."""
    out = {}
    for deg in (False, True):
        ts = [r[1] for i, r in enumerate(rows) if r[0] == deg and r[2] == 1
              and (i == 0 or r[3] == rows[i - 1][3])]
        out[deg] = (1e3 * sum(ts) / len(ts), len(ts)) if ts else (0.0, 0)
    if min(out[True][1], out[False][1]) < SPLIT_MIN_STEPS:
        print(f"{label}: degraded/undegraded decode split not measured "
              f"({out[True][1]} degraded and {out[False][1]} undegraded "
              f"steps, fewer than {SPLIT_MIN_STEPS} on a side)")
        return
    print(f"{label}: decode {out[True][0]:.2f} ms/step over {out[True][1]} "
          f"degraded steps, {out[False][0]:.2f} ms/step over "
          f"{out[False][1]} undegraded ones (wall, engine.timing) "
          f"[{device_line}]")


def check_fault_drill(mk, reqs, device_line):
    """(c1): the trace's requests without a controller, all submitted at
    once, through ``serve_resilient`` with a failure injected at step
    ``CTRL_FAIL_STEP`` (fallback shapes (8, 1), refused until the mesh
    slice and skipped, then (1, 1): ``reshard(None)``) and a straggler
    watchdog, against a fault-free run of the same requests: one restart,
    every request finished with ``length`` or ``eos`` and its fault-free
    tokens, ``compile_counts()`` restarted at the re-mesh and flat after
    it. Returns the faulty run's launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.runtime import fault_tolerance as FT
    clean = mk()
    hs = [clean.submit(r) for r in reqs]
    FT.serve_resilient(clean)
    want = [h.output for h in hs]
    eng = mk()
    hs = [eng.submit(r) for r in reqs]
    at_reshard, real = [], eng.reshard

    def reshard(mesh):
        real(mesh)
        at_reshard.append(eng.compile_counts())
    eng.reshard = reshard
    wd = FT.StragglerWatchdog()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps, restarts = FT.serve_resilient(
        eng, fallback_shapes=[(8, 1), (1, 1)], max_restarts=1,
        injector=FT.FailureInjector(at_steps=(CTRL_FAIL_STEP,)),
        watchdog=wd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if restarts != 1:
        fail(f"fault drill: {restarts} restarts, want 1")
    if any(h.finish_reason not in ("length", "eos") for h in hs):
        fail(f"fault drill: a request was lost: "
             f"{[h.finish_reason for h in hs]}")
    if [h.output for h in hs] != want:
        fail("fault drill: tokens differ from the fault-free run")
    if at_reshard != [{"prefill": 0, "decode": 0}] or \
            eng.compile_counts() != {"prefill": 0, "decode": 1}:
        fail(f"fault drill: compile_counts {at_reshard} at the re-mesh, "
             f"{eng.compile_counts()} at the end")
    slow = ", ".join(f"{s}: {1e3 * dt:.1f} ms" for s, dt, _ in wd.flagged[:4])
    print(f"fault drill: failure at step {CTRL_FAIL_STEP} of {steps}, "
          f"{restarts} restart ((8, 1) skipped, re-meshed onto one device), "
          f"all {len(hs)} requests finished with their fault-free tokens, "
          f"compile_counts restarted at the re-mesh and "
          f"{eng.compile_counts()} at the end: ok; watchdog ewma "
          f"{1e3 * wd.ewma:.2f} ms, {len(wd.flagged)} step(s) flagged "
          f"({slow}); {wall:.1f} s [{device_line}]")
    return launches


def check_controller_serving(args, res, dev, device_line, spec, params,
                             rp_d):
    """The SLO controller, fault tolerance and the trace workloads on the
    serving engine: Qwen2-7B (``--layers`` deep, bf16) with the depth
    routers of the depth phase, the trace of ``controller_trace`` on an
    injected ``StepClock`` (a fixed tick per step) on the ring (a) and the
    paged pool (b), each graphed engine held to its ``cuda_graphs=False``
    twin at ``TWIN_LAYERS`` (trajectory, events, statuses, tokens, caches);
    the fault drill (c1); the ring trace on the wall clock (c2). Returns
    the launches by path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import workloads as W
    from repro_torch.training import ServingEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    dspec = depth_spec(spec)
    reqs, arrive, targets = controller_trace(cfg.vocab_size, args.seed)
    print(f"controller trace: {len(reqs)} requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, "
          f"{min(r.max_new_tokens for r in reqs)}-"
          f"{max(r.max_new_tokens for r in reqs)} new, classes "
          f"{sorted({r.slo_class for r in reqs})}, arrivals over "
          f"{arrive[-1]:.2f} s on a clock of {CTRL_TICK_S} s per step")

    def mk(n=cfg.n_layers, g=True, layout="ring", ctrl=True, clock=None):
        kw = dict(kv_layout="paged", page_size=PAGE_SIZE,
                  n_pages=args.pages) if layout == "paged" else {}
        return ServingEngine(
            cut(params, n), rp_d, dataclasses.replace(cfg, n_layers=n),
            dspec, mode="infer", batch_size=4, max_seq=1024, device=dev,
            cuda_graphs=g, controller=make_controller(targets) if ctrl
            else None, clock=clock, **kw)

    launches = {}
    for layout in ("ring", "paged"):
        path = ("controller_serving" if layout == "ring"
                else "controller_paged_serving")
        label = f"controller {layout} (injected clock)"
        clock = W.StepClock(CTRL_TICK_S)
        engine = mk(layout=layout, clock=clock)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles, _, info, rows = run_controlled(engine, reqs, arrive,
                                                clock)   # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = ops.launch_counts()
        check_launches(path, launches[path])
        check_ladder(f"{label}, {cfg.n_layers} layers", engine, handles,
                     info, rows)
        degraded_ms(f"{label}, {cfg.n_layers} layers", rows, device_line)
        tm = engine.timing
        n_adm = len(reqs) - engine.n_rejected - engine.n_expired
        print(f"{label}, {cfg.n_layers} layers: {wall:.1f} s of wall, "
              f"{tm['prefill_s']:.1f} s in {n_adm} admissions, "
              f"{tm['decode_s']:.1f} s in {tm['decode_steps']} decode steps "
              f"[{device_line}]")
        nt = twin_depth(cfg)
        rec = PathCalls()
        twin, outs = {}, {}
        for g in (True, False):     # the eager twin's kernel calls recorded
            clock = W.StepClock(CTRL_TICK_S)
            twin[g] = mk(nt, g, layout, clock=clock)
            with (contextlib.nullcontext() if g else rec):
                hs, _, _, _ = run_controlled(twin[g], reqs, arrive, clock)
            ctrl = twin[g].controller
            outs[g] = (ctrl.trajectory, ctrl.events,
                       [(h.status, h.finish_reason, h.output) for h in hs])
        if outs[True] != outs[False]:
            fail(f"{label}: the graphed {nt}-layer engine's trajectory, "
                 f"events, statuses or tokens differ from its "
                 f"cuda_graphs=False twin's")
        print(f"{label}, {nt} layers: graphed == cuda_graphs=False twin: "
              f"trajectory ({len(outs[True][0])} evaluations), events, "
              f"statuses: ok")
        check_twin(f"{label}, {nt} layers", twin[True], twin[False],
                   [h[2] for h in outs[True][2]],
                   [h[2] for h in outs[False][2]])
        print(f"{label}: controller {engine.controller.summary()}")
        print(f"controller kernel calls of the {layout} path (recorded from "
              f"the {nt}-layer twin) [{device_line}]:")
        check_path_calls(res, dev, f"controller {layout}", rec)
        if layout == "paged":
            check_paged_calls(res, dev, rec.paged_cases(),
                              {4: "controller decode step",
                               PAGE_SIZE: "controller prefill chunk"})
        del rec, engine, twin
        gc.collect()

    launches["controller_fault_drill"] = check_fault_drill(
        lambda: mk(ctrl=False), reqs, device_line)
    gc.collect()

    engine = mk()                                # (c2): the wall clock
    handles, elapsed, info, rows = run_controlled(engine, reqs, arrive)
    check_terminal("controller ring (wall clock)", handles)
    built = [r[3] for r in rows if r[3]["decode"]]
    if engine.compile_counts() != {"prefill": 0, "decode": 1} or any(
            c != engine.compile_counts() for c in built):
        fail(f"controller ring (wall clock): compile_counts not flat: "
             f"{built}")
    summ = W.summarize(handles, elapsed, targets)
    keys = ("attainment", "goodput_tok_s", "ttft_p50_ms", "ttft_p95_ms",
            "itl_mean_ms", "itl_p95_ms", "shed", "expired")
    print(f"controller ring (wall clock), {cfg.n_layers} layers: "
          f"{summ['served']} of {summ['n']} served in {elapsed:.2f} s, "
          + ", ".join(f"{k} {summ[k]:.4g}" if isinstance(summ[k], float)
                      else f"{k} {summ[k]}" for k in keys)
          + f"; compile_counts {engine.compile_counts()} throughout "
          f"[{device_line}]")
    print(f"controller ring (wall clock): controller "
          f"{engine.controller.summary()}")
    degraded_ms("controller ring (wall clock)", rows, device_line)
    print(f"controller serving phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def tensor_signature(obj):
    """Shapes and dtypes of every tensor in ``obj`` (tuples, lists, dicts
    and dataclasses such as the policy walked in order)."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return ((tuple(obj.shape), obj.dtype),)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    elif not isinstance(obj, (list, tuple)):
        return ()
    return tuple(x for o in obj for x in tensor_signature(o))


def check_sampled_serving(args, dev, device_line, spec, params, rp,
                          requests, ring):
    """The ring serving path with per-request sampling: the six requests of
    the serving phase (same prompts, budgets and stagger) with temperature
    0 on the first two and 0.7 / 1.0, top-k 0 / 40 and distinct seeds on
    the rest. Fails unless the temperature-0 rows give the greedy run's
    tokens, a sampled request alone gives its staggered tokens, every
    decode step (greedy-only and sampling) hands ``decode_step`` tensors
    of the same shapes and dtypes, the sampling steps hand
    ``sample_tokens`` (B,) settings, and, on the paged pool in f32 at 2
    layers, two sampled requests one of which is preempted give their
    uninterrupted runs' tokens. Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import ServingEngine
    from repro_torch.training import serve as serve_mod
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=args.layers)
    knobs = [dict(), dict(), dict(temperature=0.7, top_k=40, seed=11),
             dict(temperature=1.0, seed=2 ** 32 - 1),
             dict(temperature=0.7, seed=7),
             dict(temperature=1.0, top_k=40, seed=123)]
    reqs = [r + (k,) for r, k in zip(requests, knobs)]
    mk = lambda n=cfg.n_layers, g=True: ServingEngine(
        cut(params, n), rp, dataclasses.replace(cfg, n_layers=n), spec,
        mode="infer", batch_size=4, max_seq=1024, device=dev, cuda_graphs=g)
    engine = mk()
    steps = []     # per decode step: [decode_step's, sample_tokens' tensors]
    real_step, real_sample = serve_mod.decode_step, serve_mod.sample_tokens

    def step(*a, **kw):
        steps.append([tensor_signature((a, kw))])
        return real_step(*a, **kw)

    def sample(*a, **kw):
        if steps and len(steps[-1]) == 1:     # the decode step's own call
            steps[-1].append(tensor_signature((a, kw)))
        return real_sample(*a, **kw)

    @contextlib.contextmanager
    def recording():             # a replay calls neither: the eager twin
        serve_mod.decode_step, serve_mod.sample_tokens = step, sample
        try:
            yield
        finally:
            serve_mod.decode_step, serve_mod.sample_tokens = real_step, \
                real_sample

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, reqs, stagger=True)       # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("sampled_serving", launches)
    twins(f"sampled ring infer, {twin_depth(cfg)} layers",
          lambda g: mk(twin_depth(cfg), g),
          lambda e: serve(e, reqs, stagger=True), rec=recording())
    print(f"sampled serving: {cfg.name} depth {cfg.n_layers}, the six "
          f"requests with {[k.get('temperature', 0.0) for k in knobs]} "
          f"temperatures, top-k {[k.get('top_k', 0) for k in knobs]} "
          f"[{device_line}]")
    print_timing("sampled ring serving (first run)", engine.timing,
                 device_line)
    for i, k in enumerate(knobs):
        if not k and tokens[i] != ring["tokens"][i]:
            fail(f"sampled serving: temperature-0 request {i} differs from "
                 f"the greedy run")
    sampled_differ = sum(tokens[i] != ring["tokens"][i]
                         for i, k in enumerate(knobs) if k)
    print(f"sampled serving: temperature-0 rows == the greedy run's tokens, "
          f"bit for bit: ok ({sampled_differ} of "
          f"{sum(1 for k in knobs if k)} sampled rows differ from greedy)")
    if sampled_differ == 0:
        fail("sampled serving: no sampled row differs from greedy")
    greedy = [st for st in steps if len(st[1]) == 1]
    sampled = [st for st in steps if len(st[1]) > 1]
    B = engine.B
    if not greedy or not sampled or len({st[0] for st in steps}) != 1 \
            or len({st[1] for st in sampled}) != 1 \
            or [sh for sh, _ in sampled[0][1][1:]] != [(B,)] * 4:
        fail(f"sampled serving: {len(greedy)} greedy-only and "
             f"{len(sampled)} sampling decode steps handed decode_step "
             f"{len({st[0] for st in steps})} tensor signature(s) and the "
             f"sampling ones handed sample_tokens "
             f"{len({st[1] for st in sampled})}, not one each with (B,) "
             f"settings")
    print(f"sampled serving ({twin_depth(cfg)}-layer twin): {len(greedy)} "
          f"greedy-only and {len(sampled)} "
          f"sampling decode steps handed decode_step tensors of the same "
          f"shapes and dtypes; the sampling ones handed sample_tokens "
          f"({B},) temperature, top-k, seed and position tensors, the "
          f"greedy-only ones the logits alone (a host branch): ok")
    solo_i = 4
    solo = serve(mk(), [reqs[solo_i]], stagger=False)[0]
    if solo != tokens[solo_i]:
        fail(f"sampled serving: request {solo_i} alone {solo} != staggered "
             f"{tokens[solo_i]}")
    print(f"sampled serving: staggered == solo (request {solo_i}, "
          f"temperature 0.7): ok")
    sampling_cost(dev, cfg.vocab_size, device_line)
    check_sampled_preemption(params, rp, spec, dev, args.seed)
    return launches


def sampling_cost(dev, vocab, device_line, B=4):
    """CUDA-event times of one ``sample_tokens`` call on (B, vocab) f32
    logits, every row sampling (top-k 40 on half of them) against the
    greedy argmax: graphed (the device's time) and back to back (with the
    host's cost of issuing each operation)."""
    import torch
    from repro_torch.training.serve import sample_tokens
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn(B, vocab, generator=gen, device=dev)
    temp = torch.full((B,), 0.7, device=dev)
    topk = torch.tensor([0, 40] * (B // 2), dtype=torch.int32, device=dev)
    seeds = torch.arange(B, dtype=torch.int64, device=dev)
    pos = torch.full((B,), 100, dtype=torch.int32, device=dev)
    med = lambda ts: f"{ts[len(ts) // 2]:.4f}"
    out = {}
    for name, fn in (("sampled", lambda: sample_tokens(
            logits, temp, topk, seeds, pos)), ("greedy", lambda: sample_tokens(
                logits))):
        graphed, eager = device_and_eager_ms(fn, 20)
        out[name] = f"{med(graphed)} ms graphed, {med(eager)} eager"
    print(f"sample_tokens on ({B}, {vocab}) f32 logits: sampling "
          f"{out['sampled']}; greedy argmax {out['greedy']} [{device_line}]")


def check_sampled_preemption(params, rp, spec, dev, seed, n_layers=2):
    """Two sampled 512-token requests on a paged pool one page short of
    both at full length (f32, Qwen2-7B width, ``n_layers`` layers: the
    resumed request's chunked re-prefill then rounds as the decode steps
    it replaces, so a difference is a fault of the stream, not bf16): at
    least one preemption, and each request gives the tokens of its
    uninterrupted run."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n_layers,
                              dtype="float32")
    p32, r32 = _f32_cut(params, rp, n_layers)
    rng = np.random.default_rng(seed + 5)
    reqs = [(rng.integers(0, cfg.vocab_size, 512).astype(np.int32), 16, 0.75,
             dict(temperature=0.8, top_k=40, seed=s)) for s in (21, 22)]
    need = -(-(512 + 16) // PAGE_SIZE)
    mk = lambda n_pages=None, g=True: ServingEngine(
        p32, r32, cfg, spec, mode="infer", batch_size=2, max_seq=1024,
        device=dev, kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages,
        cuda_graphs=g)
    eng = mk(2 * need)                  # one page short, plus the trash page
    got = serve(eng, reqs, stagger=False)
    if eng.n_preempted < 1:
        fail("sampled preemption: none on the short pool")
    twin = mk(2 * need, False)
    check_twin(f"sampled preemption, f32, {n_layers} layers", eng, twin, got,
               serve(twin, reqs, stagger=False))
    alone = [serve(mk(), [r], stagger=False)[0] for r in reqs]
    if got != alone:
        fail(f"sampled preemption: {got} != uninterrupted {alone}")
    print(f"sampled preemption: f32, {n_layers} layers, {2 * need}-page "
          f"pool, {eng.n_preempted} preemption(s): each request == its "
          f"uninterrupted run, bit for bit: ok")


def device_ms(fn) -> tuple:
    """(wall ms, kernel ms on the device) of ``fn()`` under torch.profiler,
    device activity only; the wall from the call to the device's end,
    without the profiler's start and stop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3


def depth_training_grid(step_fn, state, params, batch, cfg, spec, dev,
                        device_line, S, grid=((1.0, 1.0), (0.75, 1.0),
                                              (0.5, 1.0), (0.5, 0.5))):
    """The depth spec's training step (``launch.train``'s step function) at
    (depth, token) budgets set directly, each timed after one warm-up step:
    the wall time with the teacher's and student's parts and the ragged
    bucket; then one more step of the last budget under torch.profiler
    (device activity) for its device time (the step is host-bound, so the
    wall hides what the bucket saves)."""
    import torch
    from repro_torch.core.policy import ElasticPolicy, ragged_bucket
    print(f"depth training grid, {cfg.name} width, depth {cfg.n_layers}, "
          f"B={batch['tokens'].shape[0]} S={S} [{device_line}]:")
    for depth, token in grid:
        pol = ElasticPolicy.uniform(token, n_heads=cfg.n_heads).replace(
            depth_capacity=depth).to(dev)
        bucket = ragged_bucket(pol, S, spec=spec)
        timing, out = {}, {}
        run = lambda: out.update(step_fn(state, params, batch, pol, bucket,
                                         timing=timing)[1])
        run()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        loss = float(out["loss"])
        if not np.isfinite(loss):
            fail(f"depth grid ({depth}, {token}): loss {loss}")
        print(f"  (depth, token) = ({depth}, {token}) bucket {bucket}: step "
              f"{wall:.1f} ms (teacher {timing['teacher_s'] * 1e3:.1f}, "
              f"student fwd+bwd+update {timing['student_s'] * 1e3:.1f}); "
              f"loss {loss:.6f}, sel_rate {float(out['sel_rate']):.4f}")
    wall, dev_ms = device_ms(run)
    print(f"  ({depth}, {token}) once more under torch.profiler (device "
          f"activity): {wall:.1f} ms wall, {dev_ms:.1f} ms of it on the "
          f"device ({100 * dev_ms / wall:.1f} % busy)")


def print_ptxas(build, sources=None, tag=""):
    """ptxas's registers and spills per instantiation, from the build log."""
    for name, log in build.BUILD_LOG.items():
        if sources is not None and name not in sources:
            continue
        fn = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "registers" in line or "spill" in line:
                print(f"  {tag}ptxas {name} {fn}: {line.strip()}")


def sass_hgmma(build, lib, pattern, name_of) -> dict:
    """HGMMA (tensor-core) instruction count per kernel function of the
    built library ``lib`` whose mangled name matches ``pattern``
    (cuobjdump -sass, or the copy in Triton's package where the toolkit
    lacks it); ``name_of(match)`` names it."""
    import re
    import shutil
    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        tools.append(str(Path(triton.__file__).parent / "backends" /
                         "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and Path(t).exists()), None)
    if tool is None:
        fail("no cuobjdump to count the kernels' HGMMA instructions")
    path = build.BUILD_ROOT / build.source_hash() / f"lib{lib}.so"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            fn = None if m is None else name_of(m)
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def print_hgmma(build) -> None:
    """Counts the HGMMA instructions of every flash_fwd instantiation and
    of the MLP library's tensor-core up and down phases (mlp_tc, one code
    for the dense, routed and grouped-expert modes); fails unless the bf16
    Dh=128 flash kernel and every mlp_tc instantiation have some."""
    flash = sass_hgmma(
        build, "flash_attention", r"(flash_fwd_\w+?)I(\w*?)L?i(\d+)E",
        lambda m: (f"{m.group(1)}<"
                   f"{'bf16, ' if 'bfloat16' in m.group(2) else ''}"
                   f"{'f32, ' if m.group(2).endswith('f') else ''}"
                   f"{m.group(3)}>"))
    print(f"  SASS HGMMA instructions per flash_fwd instantiation: {flash}")
    if not flash.get("flash_fwd_wgmma<128>"):
        fail("the bf16 Dh=128 flash kernel has no HGMMA instruction")
    mlp = sass_hgmma(
        build, "fused_mlp", r"mlp_tcILb(\d)ELi(\d)ELb(\d)E",
        lambda m: (f"mlp_tc<{'up' if m.group(1) == '1' else 'down'}, "
                   f"{64 * int(m.group(2))} rows"
                   f"{', int8 weights' if m.group(3) == '1' else ''}>"))
    print(f"  SASS HGMMA instructions per fused_mlp tensor-core phase (all "
          f"three modes; bf16 and int8 weights): {mlp}")
    if len(mlp) != 8 or not all(mlp.values()):
        fail("a tensor-core MLP phase (up / down, 64 or 128 rows, bf16 or "
             "int8 weights) has no HGMMA instruction")


AB_KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention",
              "fused_mlp", "fused_mlp_routed", "moe_gmm")
# outputs that must be bit-identical between the two trees (kernels and
# modes this change leaves as they were, and the greedy serving path), by
# ab_turn's case prefix
AB_SAME = ("flash", "ring", "paged", "fused_mlp", "fused_mlp_routed",
           "moe_gmm", "decode")
# timed cases of a kernel the change redesigned (none: this change
# redesigned no kernel)
AB_FASTER = ()


def slice_spec():
    """The slice's elastic spec: token routing of attention and the MLP,
    head top-k, LoRA rank 1."""
    from repro_torch.core.policy import ElasticSpec
    return ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)


def ab_decode(dev, layers, reps=2):
    """``--ab``'s serving turn: item 3's six staggered requests, seed 0,
    greedy, through a ring and a paged infer engine and a ring mode="base"
    engine of the tree on the path (Qwen2-7B width, ``layers`` deep, the
    slice's spec; each tree's default engine: a tree whose engine captures
    CUDA graphs runs graphed, an older one eagerly), each served once cold
    and ``reps`` times warm. Returns each engine's tokens (one (6, 16)
    tensor, equal across its warm runs) and its warm decode ms/step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model_init, router_init
    from repro_torch.training import ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=layers)
    spec = slice_spec()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model_init(gen, cfg, spec, device=dev)
    rp = router_init(gen, cfg, spec, device=dev)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 16, b)
                for n, b in zip([64, 512, 200, 333, 128, 450],
                                [1.0, 0.75, 0.5, 1.0, 0.5, 0.75])]
    outs, ms = {}, {}
    for name, mode, kw in (
            ("ring infer", "infer", {}),
            ("paged infer", "infer", dict(kv_layout="paged",
                                          page_size=PAGE_SIZE)),
            ("ring base", "base", {})):
        eng = ServingEngine(params, rp, cfg, spec, mode=mode, batch_size=4,
                            max_seq=1024, device=dev, **kw)
        tokens = serve(eng, requests, stagger=True)          # cold
        warm = []
        for _ in range(reps):
            eng.timing.update(decode_s=0.0, decode_steps=0)
            if serve(eng, requests, stagger=True) != tokens:
                fail(f"--ab decode {name}: a warm run's tokens differ")
            warm.append(eng.timing["decode_s"] * 1e3
                        / eng.timing["decode_steps"])
        outs[f"decode {name} tokens"] = torch.tensor(tokens)
        ms[name] = warm
        print(f"--ab decode {name}: " + (
            f"graphed, compile_counts {eng.compile_counts()}"
            if getattr(eng, "cuda_graphs", False) else "eager"))
        del eng
    return outs, ms


def ab_turn(tree: Path, out: Path, layers: int) -> None:
    """One turn of ``--ab``: ``check_flash``, ``check_decode`` (ring, no
    split edges), ``check_paged_decode``, ``check_fused_mlp``,
    ``check_fused_mlp_routed`` and ``check_moe_gmm`` (a moefied Qwen2-7B
    call, 8 experts, ragged counts) on the kernels of the checkout at
    ``tree`` (its ``src`` first on the path, its kernels built into its
    own tree), inputs drawn from seed 0, each held to its plain version
    under ``TOL``, then ``ab_decode`` on its serving engines; saves the
    outputs, each kernel's timed-case medians and the warm decode ms/step
    to ``out``."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    build.build()
    print_ptxas(build, None, f"{tree}: ")
    cfg = get_config("qwen2-7b")
    D, Fd = cfg.d_model, cfg.d_ff
    torch.manual_seed(0)
    rng, dev, res = np.random.default_rng(0), torch.device("cuda"), Results()
    counts = np.array([[512, 301, 0, 77, 512, 450, 128, 1]])
    outs = {}
    for name, fn in (("flash", lambda: check_flash(res, rng, dev, 28, 4,
                                                   128)),
                     ("ring", lambda: check_decode(res, rng, dev, 28, 4, 128,
                                                   1024, edges=False)),
                     ("paged", lambda: check_paged_decode(
                         res, rng, dev, 28, 4, 128, 1024)),
                     ("fused_mlp", lambda: check_fused_mlp(res, dev, D, Fd)),
                     ("fused_mlp_routed", lambda: check_fused_mlp_routed(
                         res, rng, dev, D, Fd)),
                     ("moe_gmm", lambda: check_moe_gmm(
                         res, dev, "moefied", [((1, 8, 512, D), counts)],
                         moefied_weights(dev, D, Fd, 8), timed=True))):
        outs.update({f"{name} {k}": o.cpu() for k, o in fn().items()})
    dec_outs, dec_ms = ab_decode(dev, layers)
    outs.update(dec_outs)
    ms = {}
    for n in AB_KERNELS:
        row = res.rows[n]
        ms[(n, None)] = (row.get("graphed_ms"), row["ms"])
        for label, case in row.get("cases", {}).items():
            ms[(n, label)] = (None, case["ms"])
    torch.save({"outs": outs, "ms": ms, "decode_ms": dec_ms}, out)


def kernel_ab(parent: Path, layers: int) -> int:
    """``--ab PARENT``: the six kernels and the greedy serving engines of
    the checkout at PARENT (p) and of this one (c) in turns p c c p, each
    turn a process of its own (``ab_turn``) on the same seeded inputs at
    Qwen2-7B widths, each turn within ``TOL`` of the plain version. Prints
    each kernel's timed medians per turn (graphed and eager for attention,
    eager for the MLP kernels, whose calls are far above the host's cost
    of issuing them), each engine's warm decode ms/step per turn, and
    whether the change was faster than the parent in every turn at the
    cases it redesigned (``AB_FASTER``); fails unless each tree's outputs
    are equal bit for bit across its own two turns, and unless the kernels
    and paths of ``AB_SAME`` give the same bits in both trees."""
    import shutil
    import tempfile
    import torch
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    turns = [("p", parent), ("c", ROOT), ("c", ROOT), ("p", parent)]
    try:
        got = []
        for i, (_, tree) in enumerate(turns):
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--ab-turn", str(tree), str(tmp / f"{i}.pt"),
                            "--layers", str(layers)],
                           check=True)
            got.append(torch.load(tmp / f"{i}.pt"))
    finally:
        shutil.rmtree(tmp)
    ok = True
    for tree, (i, j) in (("p", (0, 3)), ("c", (1, 2))):
        same = all(torch.equal(got[i]["outs"][k], got[j]["outs"][k])
                   for k in got[i]["outs"])
        ok = ok and same
        print(f"--ab {tree} ({parent if tree == 'p' else ROOT}): outputs "
              f"bit for bit equal in its two turns: {same}")
    for prefix in AB_SAME:
        keys = [k for k in got[0]["outs"] if k.startswith(prefix + " ")]
        same = bool(keys) and all(
            torch.equal(got[0]["outs"][k], got[1]["outs"][k]) for k in keys)
        ok = ok and same
        print(f"--ab {prefix}: {len(keys)} outputs bit for bit equal between "
              f"the parent and the change: {same}")
    for key in got[0]["ms"]:
        n, label = key
        for i, form in enumerate(("graphed", "eager")):
            if got[0]["ms"][key][i] is None:
                continue
            ms = " / ".join(f"{t} {g['ms'][key][i]:.4f}"
                            for (t, _), g in zip(turns, got))
            print(f"--ab {n}{'' if label is None else ' ' + label}, turns "
                  f"p c c p, timed-case median ms, {form}: {ms}")
    for name in got[0]["decode_ms"]:
        ms = " / ".join(f"{t} " + ", ".join(
            f"{v:.2f}" for v in g["decode_ms"][name])
            for (t, _), g in zip(turns, got))
        print(f"--ab decode {name}, six staggered requests, {layers} "
              f"layers, turns p c c p, warm ms/step per run: {ms}")
    for key in AB_FASTER:
        t = [g["ms"][key][1] for g in got]
        print(f"--ab {key[0]}{'' if key[1] is None else ' ' + key[1]}: the "
              f"change faster than the parent in every turn: "
              f"{max(t[1], t[2]) < min(t[0], t[3])}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served Qwen2-7B (width stays full)")
    ap.add_argument("--train-layers", type=int, default=28,
                    help="depth of the trained Qwen2-7B (width stays full)")
    ap.add_argument("--moe-layers", type=int, default=12,
                    help="depth of the served Qwen1.5-MoE-A2.7B (width "
                         "stays full; 24 is the model's)")
    ap.add_argument("--pages", type=int, default=None,
                    help="pages in the paged serving pool (default the "
                         "ring-equivalent 4 * 64 + 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=Path, metavar="PARENT",
                    help="run only the six kernels' checks and the greedy "
                         "serving engines (--layers deep) on the checkout "
                         "at PARENT and on this one in turns (p c c p): "
                         "each tree bit for bit across its turns, the "
                         "unchanged kernels and paths bit for bit across "
                         "the trees, within TOL, the timed medians and the "
                         "warm decode ms/step")
    ap.add_argument("--ab-turn", nargs=2, type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--gmm-tile-rows", action="store_true",
                    help="also time moe_gmm's heaviest call of each expert "
                         "path at 64- and at 128-row tiles")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ab_turn:
        ab_turn(*args.ab_turn, args.layers)
        return 0
    if args.ab:
        return kernel_ab(args.ab, args.layers)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    device_line = card_line()
    print(f"device: {device_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()
    phase_s, t_phase = {}, [t_start]

    def done(phase):             # wall time since the previous phase ended
        now = time.perf_counter()
        phase_s[phase] = round(now - t_phase[0], 1)
        t_phase[0] = now

    t_build = build.build()
    print(f"kernel build (nvcc sm_90a, {len(build.SOURCES)} sources in "
          f"parallel): {t_build:.1f} s")
    print_ptxas(build)
    print_hgmma(build)

    dev = torch.device("cuda")
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    cfg = get_config("qwen2-7b")
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    print(f"kernel checks at {cfg.name} shapes [{device_line}]:")
    res = Results()
    check_flash(res, rng, dev, H, K, Dh)
    check_fused_mlp(res, dev, cfg.d_model, cfg.d_ff)
    check_fused_mlp_routed(res, rng, dev, cfg.d_model, cfg.d_ff)
    check_decode(res, rng, dev, H, K, Dh, 1024)
    check_paged_decode(res, rng, dev, H, K, Dh, 1024)
    print(f"int8 operand forms at {cfg.name} shapes [{device_line}]:")
    check_int8_decode(res, rng, dev, H, K, Dh, 1024)
    check_int8_paged(res, rng, dev, H, K, Dh, 1024)
    check_int8_mlp(res, dev, cfg.d_model, cfg.d_ff)
    torch.cuda.synchronize()
    done("build, kernel checks")

    def free():                  # engines, caches and dropped weights
        gc.collect()
        torch.cuda.empty_cache()

    spec = slice_spec()
    paths = {}
    paths["serving"], params, rp, requests, teacher, ring = check_serving(
        args, dev, device_line, spec)
    ring["teacher"] = teacher
    free()
    done("serving")
    paths["paged_serving"], paged = check_paged_serving(
        args, res, dev, device_line, spec, params, rp, requests, ring)
    free()
    done("paged serving")
    paths.update(check_quant_serving(args, res, dev, device_line, spec,
                                     params, rp, requests, ring, paged))
    free()
    check_int8_fork_preemption(params, rp, spec, dev, args.seed)
    free()
    done("int8 serving")
    paths.update(check_train_serving(args, res, dev, device_line, spec,
                                     params, rp, requests, ring))
    free()
    done("train-mode serving")
    check_gradients(params, rp, spec, dev, args.seed)
    free()
    paths["training"] = check_training(args, params, rp, spec, dev,
                                       device_line)
    free()
    done("gradients, training")
    depth_paths, rp_d = check_depth_serving(
        args, res, dev, device_line, spec, params, rp, requests, ring, paged)
    paths.update(depth_paths)
    free()
    done("depth serving")
    check_gradients(params, rp_d, depth_spec(spec), dev, args.seed,
                    budget=0.75, depth=0.5)
    free()
    paths["depth_training"] = check_training(
        args, params, rp_d, depth_spec(spec), dev, device_line)
    free()
    done("depth gradients, training")
    paths.update(check_controller_serving(args, res, dev, device_line, spec,
                                          params, rp_d))
    del rp_d
    free()
    done("controller serving")
    paths["sampled_serving"] = check_sampled_serving(
        args, dev, device_line, spec, params, rp, requests, ring)
    free()
    done("sampled serving")
    # moe_gmm is held to its plain version at the calls each expert path
    # made (recorded during the path, replayed after it)
    moefied = moefied_weights(dev, cfg.d_model, cfg.d_ff,
                              expert_spec(spec).mlp_n_experts)
    with PathCalls("moe_gmm") as rec:
        paths["expert_serving"], rp_e = check_expert_serving(
            args, dev, device_line, spec, params, requests, teacher)
    free()
    print(f"moe_gmm at the expert serving path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "moefied qwen2-7b serving", rec.gmm_cases(), moefied,
                  timed=True, tile_rows=args.gmm_tile_rows)
    free()
    done("expert serving")
    check_gradients(params, rp_e, expert_spec(spec), dev, args.seed)
    free()
    with PathCalls("moe_gmm") as rec:
        paths["expert_training"] = check_training(
            args, params, rp_e, expert_spec(spec), dev, device_line)
    free()
    print(f"moe_gmm at the expert training path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "moefied qwen2-7b training", rec.gmm_cases(),
                  moefied, timed=False, tile_rows=args.gmm_tile_rows)
    del params, rp, rp_e         # the Qwen2-7B weights leave the card
    free()
    done("expert gradients, training")
    with PathCalls("moe_gmm") as rec:
        paths["native_serving"], native = check_native_serving(
            args, dev, device_line)
    free()
    print(f"moe_gmm at the native MoE serving path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "native qwen1.5-moe serving", rec.gmm_cases(),
                  native_weights(dev, get_config("qwen2-moe-a2.7b")),
                  timed=False, tile_rows=args.gmm_tile_rows)
    free()
    done("native MoE serving")
    with PathCalls("moe_gmm") as rec:
        paths["quant_native_serving"] = check_native_int8_serving(
            dev, device_line, native)
    del native
    free()
    print(f"int8 moe_gmm at the native MoE int8 path's calls "
          f"[{device_line}]:")
    check_int8_gmm(res, dev, "native int8", rec.gmm_cases(),
                   get_config("qwen2-moe-a2.7b"))
    done("native MoE int8 serving")
    kernels = [dict(name=n, route="cuda", source=SOURCES[n][0],
                    replaces=SOURCES[n][1],
                    launches=sum(p[n] for p in paths.values()),
                    launches_by_path={k: p[n] for k, p in paths.items()},
                    **res.rows[n]) for n in SOURCES]
    print(f"phase wall times (s): {phase_s}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
