#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (built for H100).

    python3 chip_smoke.py [--layers N] [--train-layers N] [--moe-layers N]
                          [--seed S]

1. Prints the card (nvidia-smi name and power limit), builds the
   hand-written CUDA kernels from src/repro_torch/kernels/csrc with nvcc
   (sm_90a, one process per source, in parallel) and prints the build time.
2. Holds each kernel against its plain PyTorch version at Qwen2-7B shapes,
   in bf16 and f32, with ragged counts, kv_valid holes, a part-filled ring
   and a routed selection; prints the max error beside the tolerance, and
   times the kernel, the plain version and (attention) one SDPA call with
   CUDA events. moe_gmm is held to its plain version after each expert
   path (items 6, 8, 9) at the calls that path made: their shapes and
   group counts are recorded during the path and replayed (random x and
   weights in the path's weight layout, bf16 and f32, with and without
   routing weights, exact zeros past every count), the largest timed.
3. Serving: 6 staggered mixed-budget requests through ``ServingEngine`` at
   Qwen2-7B full width (random bf16 weights from --seed; --layers cuts depth
   only) and fails unless budget-1.0 requests equal a mode="base" engine
   bit for bit, a request served alone equals its staggered tokens, and
   every serving kernel launched during the run. Prints prefill and decode
   rates of the main run and of the (warm) teacher run, and the device
   kernel time of the solo run under torch.profiler.
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
10. Prints one JSON line of per-kernel results (launches by path), the card
   line again, and as the last line {"ok": true, "device": {...}}.

Any failed phase raises and the script exits non-zero before that line.
TF32 is off for matmuls and cuDNN (both set below): f32 means f32.
"""
from __future__ import annotations

import argparse
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
}

# kernels each path must launch (the teacher of expert training is dense)
PATH_KERNELS = {
    "serving": ("flash_attention", "fused_mlp", "decode_attention"),
    "training": ("flash_attention", "fused_mlp", "fused_mlp_routed"),
    "expert_serving": ("flash_attention", "moe_gmm", "decode_attention"),
    "expert_training": ("flash_attention", "fused_mlp", "moe_gmm"),
    "native_serving": ("flash_attention", "moe_gmm", "decode_attention"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, reps: int = 5, warmup: int = 5) -> list:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls,
    measured with CUDA events ``reps`` times after ``warmup`` calls; returns
    the ``reps`` means, sorted (median is the reported time, the ends are
    its spread)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sorted(out)


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

    def compare(self, name, case, got, want, kind):
        """Per element: |got - want| <= atol + rtol * |want|."""
        import torch
        diff = (got.float() - want.float()).abs()
        atol, rtol = TOL[kind]
        tol = atol + rtol * want.float().abs()
        err = float(diff.max())
        worst = float((diff / tol).max())       # <= 1 everywhere to pass
        ok = bool(torch.isfinite(got.float()).all()) and worst <= 1.0
        n_diff = int((got != want).sum())
        print(f"  {name:17s} {case:44s} max_abs_err {err:.3e}  worst "
              f"err/tol {worst:.3f} (tol atol {atol:g} + rtol {rtol:g} * "
              f"|plain| per element; {n_diff} of {got.numel()} elements "
              f"differ)  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def timing(self, name, ms, plain_ms, flops, nbytes, kind, library_ms):
        """Each time is the sorted list from ``cuda_ms``; the median goes
        into the result line, the spread is printed."""
        b, by = bound_ms(flops, nbytes, kind)
        med = lambda ts: None if ts is None else ts[len(ts) // 2]
        self.rows[name].update(ms=med(ms), plain_ms=med(plain_ms), bound_ms=b,
                               bound_by=by, library_ms=med(library_ms))
        fmt = lambda ts: ("n/a" if ts is None else f"{med(ts):.4f} ms "
                          f"[{ts[0]:.4f}-{ts[-1]:.4f}]")
        print(f"  {name:17s} median [min-max] of {len(ms)}: kernel {fmt(ms)}"
              f"  plain {fmt(plain_ms)}  library {fmt(library_ms)}  bound "
              f"{b:.4f} ms ({by})")


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
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    cases = [  # (dtype, B, S, keep fraction, counts, timed)
        ("bf16", 1, 512, 0.6, None, True),
        ("f32", 2, 384, 0.7, [384, 200], False),
        ("bf16", 2, 256, 0.5, [256, 77], False),
    ]
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
        res.compare("flash_attention", f"{kind} B={B} S={S} H={H} K={K} "
                    f"keep={keep} cnt={counts}", got, want, kind)
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
        kx = k.repeat_interleave(H // K, dim=2).transpose(1, 2)
        vx = v.repeat_interleave(H // K, dim=2).transpose(1, 2)
        qt = q.transpose(1, 2)
        res.timing(
            "flash_attention",
            cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 20),
            cuda_ms(lambda: ops.flash_attention(q, k, v, backend="ref", **kw),
                    5),
            4 * Dh * pairs, nbytes, kind,
            cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kx, vx, attn_mask=mask[:, None]), 20))


def check_fused_mlp(res: Results, dev, D, Fd):
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, x shape, D, F, act, gated, token weights, counts, timed)
        ("bf16", (1, 512), D, Fd, "swiglu", True, False, None, True),
        ("f32", (2, 96), D, Fd, "swiglu", True, True, [96, 41], False),
        ("f32", (1, 70), 256, 512, "gelu", False, True, [70], False),
    ]
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
        res.compare("fused_mlp", f"{kind} x={tuple(x.shape)} F={f} {act} "
                    f"cnt={counts}", run(), run("ref"), kind)
        if not timed:
            continue
        rows = xs[0] * xs[1]
        n_mats = 3 if gated else 2
        esz = x.element_size()
        nbytes = (n_mats * d * f + 2 * x.numel()) * esz
        res.timing("fused_mlp", cuda_ms(run, 5), cuda_ms(
            lambda: run("ref"), 3), 2 * rows * d * f * n_mats, nbytes, kind,
            None)


def check_fused_mlp_routed(res: Results, rng, dev, D, Fd):
    """The routed MLP at a training step's shapes: B=2, S=512, a 256-row
    bucket with counts (256, 200); plus a small ungated case whose bucket
    is the whole sequence. Rows outside the live selection must be exactly
    zero."""
    import torch
    from repro_torch.kernels import ops
    cases = [  # (dtype, B, S, Kb, D, F, act, gated, counts, timed)
        ("bf16", 2, 512, 256, D, Fd, "swiglu", True, [256, 200], True),
        ("f32", 2, 512, 256, D, Fd, "swiglu", True, [256, 200], False),
        ("f32", 2, 96, 96, 256, 512, "gelu", False, [96, 0], False),
    ]
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
        res.compare("fused_mlp_routed", f"{kind} x={tuple(x.shape)} Kb={Kb} "
                    f"F={f} {act} cnt={counts}", got, run("ref"), kind)
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
        res.timing("fused_mlp_routed", cuda_ms(run, 5),
                   cuda_ms(lambda: run("ref"), 3), 2 * rows * d * f * n_mats,
                   nbytes, kind, None)


def _ring(rng, B, L, t, keep):
    """Ring-cache positions written up to per-slot t (slot = pos % L), -1
    for never-written slots, and a routing validity mask."""
    slots = np.arange(L)[None, :]
    tt = np.asarray(t)[:, None]
    pos = np.where(slots <= tt % L, tt - tt % L, tt - tt % L - L) + slots
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    return pos, rng.random((B, L)) < keep


def check_decode(res: Results, rng, dev, H, K, Dh, L):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
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
        res.compare("decode_attention", f"{kind} B={B} L={L} H={H} K={K} "
                    f"window={window} ring holes", run(), run("ref"), kind)
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
        qt = q.transpose(1, 2)
        kxs = [a.repeat_interleave(H // K, dim=2).transpose(1, 2) for a in ks]
        vxs = [a.repeat_interleave(H // K, dim=2).transpose(1, 2) for a in vs]
        dec = lambda backend: cycling(lambda i: ops.decode_attention(
            q, ks[i], vs[i], pos, tv, valid, window=window,
            backend=backend), n_sets)
        mib = lambda ts: sum(a.numel() for a in ts) * esz / 2 ** 20
        print(f"  decode_attention  timed L2-cold: rotating over {n_sets} "
              f"K/V sets ({mib(ks + vs):.0f} MiB; SDPA's K/V repeated to "
              f"{H} heads: {mib(kxs + vxs):.0f} MiB)")
        res.timing("decode_attention", cuda_ms(dec(None), 50),
                   cuda_ms(dec("ref"), 10),
                   4 * Dh * H * float(att.sum()), nbytes, kind,
                   cuda_ms(cycling(lambda i: F.scaled_dot_product_attention(
                       qt, kxs[i], vxs[i], attn_mask=mask), n_sets), 50))
        del ks, vs, kxs, vxs


class GmmCalls:
    """Records the shape and group counts of every ``moe_gmm`` call made
    while active. The model calls ``ops.moe_gmm`` through the module, so a
    delegating wrapper put there sees each call; the kernel wrapper and its
    launch count are untouched."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self._ops, self._orig = [], ops, ops.moe_gmm

        def record(x, wi, wo, wg=None, weights=None, group_counts=None,
                   *a, **kw):
            self.calls.append((tuple(x.shape), group_counts.detach().clone()))
            return self._orig(x, wi, wo, wg, weights, group_counts, *a, **kw)
        ops.moe_gmm = record
        return self

    def __exit__(self, *exc):
        self._ops.moe_gmm = self._orig

    def cases(self):
        """The heaviest call (most dispatched rows) of each distinct shape
        as (shape, (B, E) numpy counts), the largest shape first."""
        best = {}
        for shape, cnt in self.calls:
            c = cnt.cpu().numpy().reshape(shape[0], shape[1])
            if shape not in best or c.sum() > best[shape].sum():
                best[shape] = c
        return sorted(best.items(), key=lambda kv: (-np.prod(kv[0]),
                                                    -kv[1].sum()))


def check_moe_gmm(res, dev, label, cases, weights_of, timed):
    """Replays a path's own ``moe_gmm`` calls on the card: each recorded
    (shape, counts) with random x and routing weights and the layout's
    expert weights ``weights_of(dtype) -> (wi, wg, wo)`` (strided moefied
    views or contiguous native stacks), in bf16 and f32, with and without
    routing weights, against the plain version; every slot at or past its
    count must be exactly zero. The largest call in bf16 without weights
    (the path's own call) is timed: ``timed`` makes it the row's timing,
    else it is printed beside it."""
    import torch
    from repro_torch.kernels import ops
    print(f"  moe_gmm {label}: {len(cases)} distinct call shapes, the "
          f"heaviest call of each replayed")
    for kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        wi, wg, wo = weights_of(dt)
        Fe = wi.shape[-1]
        for ci, (shape, counts) in enumerate(cases):
            B, E, C, D = shape
            x = torch.randn(shape, device=dev).to(dt)
            cnt = torch.from_numpy(counts.astype(np.int32)).to(dev)
            live = torch.arange(C, device=dev) < cnt[..., None]
            for weighted in (False, True):
                rw = torch.rand(B, E, C, device=dev) if weighted else None
                run = lambda backend=None: ops.moe_gmm(
                    x, wi, wo, wg, rw, cnt, act="swiglu", backend=backend)
                got = run()
                res.compare("moe_gmm", f"{kind} {label} {tuple(shape)} rows "
                            f"{int(counts.sum())} w={'y' if weighted else 'n'}",
                            got, run("ref"), kind)
                if got[~live].count_nonzero() != 0:
                    fail(f"moe_gmm {label} {kind} {shape}: a slot past its "
                         f"count is not zero")
            if kind == "bf16":
                print(f"  moe_gmm           {label} {tuple(shape)}: counts "
                      f"sum {int(counts.sum())}, {int((counts == 0).sum())} "
                      f"empty group(s), {int((~live).sum())} slots past "
                      f"their counts: all exactly zero")
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
            args = (cuda_ms(main, 5), cuda_ms(lambda: main("ref"), 3),
                    6 * D * Fe * rows, nbytes, kind, None)
            if timed:
                res.timing("moe_gmm", *args)
                continue
            b, by = bound_ms(*args[2:5])
            med = lambda ts: ts[len(ts) // 2]
            print(f"  moe_gmm           {label} {tuple(shape)} median "
                  f"[min-max] of 5: kernel {med(args[0]):.4f} ms "
                  f"[{args[0][0]:.4f}-{args[0][-1]:.4f}]  plain "
                  f"{med(args[1]):.4f} ms [{args[1][0]:.4f}-"
                  f"{args[1][-1]:.4f}]  bound {b:.4f} ms ({by})")
        del wi, wg, wo


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

def serve(engine, requests, stagger: bool):
    """Submit two requests, step twice, submit the rest, run to the end."""
    from repro_torch.training import GenRequest
    first = 2 if stagger else len(requests)
    handles = [engine.submit(GenRequest(p, n, budget=b))
               for p, n, b in requests[:first]]
    if stagger:
        for _ in range(2):
            engine.step()
        handles += [engine.submit(GenRequest(p, n, budget=b))
                    for p, n, b in requests[first:]]
    while not all(h.done for h in handles):
        if engine.step() == 0:
            fail("serving engine stalled")
    return [list(h.output) for h in handles]


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
          f" % busy, profiler on)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  "
              f"{e.key[:100]}")


def profiled(fn, top=8):
    """``fn()`` under torch.profiler; prints the device kernel time by name
    beside the wall time of the window. Returns fn's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    mk = lambda mode: ServingEngine(params, rp, cfg, spec, mode=mode,
                                    batch_size=4, max_seq=1024, device=dev)

    engine = mk("infer")
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("serving", launches)
    print_timing("main path (first run, cold)", engine.timing, device_line)
    for toks in tokens:
        if len(toks) != 16 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"bad generated tokens {toks}")

    base = mk("base")
    teacher = serve(base, requests, stagger=True)
    print_timing("teacher, mode='base' (warm)", base.timing, device_line)
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
    return launches, params, rp, requests, teacher


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
    mk = lambda: ServingEngine(params, rp, cfg, espec, mode="infer",
                               batch_size=4, max_seq=1024, device=dev)
    engine = mk()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("expert_serving", launches)
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
                    rel_tol=2e-3):
    """Router gradients of one distillation loss at Qwen2-7B full width,
    ``n_layers`` layers, f32: the kernel path (backend "cuda") against the
    plain path (backend "ref") on the same batch and policy. A leaf passes
    when max |g_kernel - g_plain| <= rel_tol * max |g_plain|. A leaf whose
    kernel-path gradient is all zero while the plain one is not fails (the
    mark of a kernel whose autograd plumbing is missing). With expert
    routing, every expert routing decision must also be the same on both
    paths: which experts each token selects, and which (token, expert)
    pairs each expert's capacity keeps (``expert_decisions``)."""
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
                                n_experts=spec.mlp_n_experts).to(dev)
    bucket = ragged_bucket(pol, S)
    tokens = torch.from_numpy(LMDataPipeline(
        vocab=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=seed).batch_at(0)).to(dev)
    out, picks = {}, {}
    for backend in ("cuda", "ref"):
        sp = dataclasses.replace(spec, kernel_backend=backend)
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          r32)
        with expert_decisions() as picks[backend]:
            loss, m = make_loss_fn(cfg, sp)(leaves, p32, {"tokens": tokens},
                                            pol, bucket)
        flat = tree_leaves(leaves)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        out[backend] = (float(loss.detach()), float(m["sel_rate"]),
                        [torch.zeros_like(t) if g is None else g
                         for g, t in zip(gs, flat)])
        torch.cuda.synchronize()
    (lk, sk, gk), (lr_, sr, gr) = out["cuda"], out["ref"]
    label = "experts" if spec.expert_routed else "dense"
    print(f"gradient check ({label}): qwen2-7b width, {n_layers} layers, f32,"
          f" B={B} S={S}, budget {budget} (bucket {bucket}): loss kernel "
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
    the teacher is reported instead of held to 0, and every expert router
    leaf must get a non-zero gradient in the repeated plan step."""
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
    path = "expert_training" if experts else "training"
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
    if experts:
        exp_ids = {id(layer["expert"]["w"]) for layer in leaves["layers"]}
        dead = [j for j, (t, g) in enumerate(zip(flat, runs[0][1]))
                if id(t) in exp_ids and (g is None or not bool(g.any()))]
        if dead or not exp_ids:
            fail(f"expert router leaves without a gradient: {dead}")
        print(f"all {len(exp_ids)} expert router leaves get a non-zero "
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
    return launches


def check_native_serving(args, dev, device_line):
    """Qwen1.5-MoE-A2.7B at its published widths (qwen2-moe-a2.7b,
    --moe-layers deep, random bf16 weights from --seed) with its registered
    elastic config: expert top-k over the 60 experts, token routing, head
    top-k, LoRA. Five staggered requests of 64-512 tokens; the request
    admitted mid-decode alone must give its staggered tokens. Returns the
    launches."""
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
    mk = lambda: ServingEngine(params, rp, cfg, spec, mode="infer",
                               batch_size=4, max_seq=1024, device=dev)
    engine = mk()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens = serve(engine, requests, stagger=True)    # the main path
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("native_serving", launches)
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
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served Qwen2-7B (width stays full)")
    ap.add_argument("--train-layers", type=int, default=28,
                    help="depth of the trained Qwen2-7B (width stays full)")
    ap.add_argument("--moe-layers", type=int, default=24,
                    help="depth of the served Qwen1.5-MoE-A2.7B (width "
                         "stays full)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ElasticSpec
    from repro_torch.kernels import build

    device_line = card_line()
    print(f"device: {device_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()
    t_build = build.build()
    print(f"kernel build (nvcc sm_90a, {len(build.SOURCES)} sources in "
          f"parallel): {t_build:.1f} s")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    torch.cuda.synchronize()

    def free():                  # engines, caches and dropped weights
        gc.collect()
        torch.cuda.empty_cache()

    spec = ElasticSpec(mlp_token_routed=True, mha_token_routed=True,
                       mha_head_routed=True, lora_rank=1)
    paths = {}
    paths["serving"], params, rp, requests, teacher = check_serving(
        args, dev, device_line, spec)
    free()
    check_gradients(params, rp, spec, dev, args.seed)
    free()
    paths["training"] = check_training(args, params, rp, spec, dev,
                                       device_line)
    free()
    # moe_gmm is held to its plain version at the calls each expert path
    # made (recorded during the path, replayed after it)
    moefied = moefied_weights(dev, cfg.d_model, cfg.d_ff,
                              expert_spec(spec).mlp_n_experts)
    with GmmCalls() as rec:
        paths["expert_serving"], rp_e = check_expert_serving(
            args, dev, device_line, spec, params, requests, teacher)
    free()
    print(f"moe_gmm at the expert serving path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "moefied qwen2-7b serving", rec.cases(), moefied,
                  timed=True)
    free()
    check_gradients(params, rp_e, expert_spec(spec), dev, args.seed)
    free()
    with GmmCalls() as rec:
        paths["expert_training"] = check_training(
            args, params, rp_e, expert_spec(spec), dev, device_line)
    free()
    print(f"moe_gmm at the expert training path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "moefied qwen2-7b training", rec.cases(),
                  moefied, timed=False)
    del params, rp, rp_e         # the Qwen2-7B weights leave the card
    free()
    with GmmCalls() as rec:
        paths["native_serving"] = check_native_serving(args, dev,
                                                       device_line)
    free()
    print(f"moe_gmm at the native MoE serving path's calls [{device_line}]:")
    check_moe_gmm(res, dev, "native qwen1.5-moe serving", rec.cases(),
                  native_weights(dev, get_config("qwen2-moe-a2.7b")),
                  timed=False)
    kernels = [dict(name=n, route="cuda", source=SOURCES[n][0],
                    replaces=SOURCES[n][1],
                    launches=sum(p[n] for p in paths.values()),
                    launches_by_path={k: p[n] for k, p in paths.items()},
                    **res.rows[n]) for n in SOURCES]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
