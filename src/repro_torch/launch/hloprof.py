"""FLOP and byte accounting of the port's eager programs on the card.

The counterpart of the JAX package's ``launch/hloprof.py``. There, XLA's
cost analysis counts a compiled (fused) program, and the HLO text gives
each instruction's operand and output shapes. Here nothing is compiled: an
op recorder (``OpRecorder``, a ``TorchDispatchMode``) sees every aten
operation a function runs, with its operands and outputs, and every kernel
wrapper reports itself (``kernels/ops.py``: a ``ctypes`` launch and a CUDA
graph replay are invisible to a dispatch mode, and a plain version counted
op by op would count its masked pairs and its step-by-step arithmetic).
So:

* ``profile_ops`` is op name -> {count, bytes, moved}: ``bytes`` the
  outputs' bytes, ``moved`` the operands' and outputs' bytes, as
  ``profile_text`` reads them from HLO. A kernel call counts under
  ``kernel.<name>``, its ``moved`` the bytes its ``kernel_cost`` says it
  must move. Views move nothing and are skipped, as HLO's bitcasts are.
* ``moved`` is a per-op upper bound, not XLA's number: XLA fuses a chain of
  elementwise ops into one pass over HBM, where the port runs each op of
  the chain on its own, and an in-place write into a cache counts the
  cache as an operand and an output. ``bytes_moved`` overstates the HBM
  traffic of an unfused chain by design: it is what the eager program
  touches.
* ``lowered_flops`` counts matrix products, convolutions and SDPA by
  ``torch.utils.flop_counter``'s formulas and each kernel call by its
  ``kernel_cost``; it runs the function (there is no lowering without
  running it), the backward too when the function runs one.
* ``cache_read_bytes`` is the bytes of the cache tensors a serving
  engine's decode step reads.

The card's peak rates live here (``PEAK_FLOPS``, ``PEAK_BYTES``): a kernel
case's bound (``bound_ms``) and a whole step's share of the card
(``step_shares``) come from them.

Usage:
    from repro_torch.launch.hloprof import profile_ops, top_table
    print(top_table(profile_ops(step, *args), n=25))
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops as OPS

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}   # H100 SXM dense; f32 off tensor cores
PEAK_BYTES = 3.35e12                          # H100 SXM HBM3


def bound_ms(flops: float, nbytes: float, kind: str) -> tuple:
    """(ms, "operations" | "bytes"): the least time the card takes for
    ``flops`` operations of ``kind`` ("bf16" or "f32") and ``nbytes`` of
    HBM traffic, the larger of the two and what decides it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def step_shares(flops, nbytes: float, device_ms: float,
                kind: str = "bf16") -> dict:
    """A whole step's share of the card's peaks over its measured device
    time: ``mfu`` = the time ``flops`` take at the peak rate of ``kind``
    (``flops`` a dict kind -> FLOPs: each at its own rate) over device_ms,
    ``hbm_share`` = nbytes over device_ms at the HBM rate. Above 1.0 a
    count is wrong."""
    by = flops if isinstance(flops, dict) else {kind: flops}
    s = device_ms * 1e-3
    return {"mfu": sum(f / PEAK_FLOPS[k] for k, f in by.items()) / s,
            "hbm_share": nbytes / (s * PEAK_BYTES)}


def _kind(dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


# ------------------------------ the recorder ---------------------------------

class TensorMeta(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    device: str
    storage: int      # the storage's data pointer (aliasing)
    nbytes: int


class OpRecord(NamedTuple):
    """One aten operation: its name (``aten.mm.default``), tensor operands
    and outputs, the other arguments (as text) and whether it is a view."""
    name: str
    ins: tuple
    outs: tuple
    scalars: tuple
    view: bool


def tensor_bytes(*xs) -> int:
    """Bytes of tensors, or of (shape, dtype) pairs: the ``shape_bytes`` of
    a type string."""
    total = 0
    for x in xs:
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()
        else:
            shape, dtype = x
            n = 1
            for d in shape:
                n *= int(d)
            total += n * torch.empty((), dtype=dtype).element_size()
    return total


def _meta(t: torch.Tensor) -> TensorMeta:
    ptr = t.untyped_storage().data_ptr() if t.device.type != "meta" else 0
    return TensorMeta(tuple(t.shape), t.dtype, t.device.type, ptr,
                      t.numel() * t.element_size())


class OpRecorder(TorchDispatchMode):
    """``with OpRecorder() as rec:`` records every aten operation into
    ``rec.ops`` (``OpRecord``) and every kernel wrapper call into the same
    list (``ops.KernelCall``), in order. Nothing a kernel wrapper runs
    inside its call is recorded (the call stands for it). ``cost``: record
    each kernel call's ``kernel_cost``."""

    def __init__(self, cost: bool = True):
        super().__init__()
        self.ops: list = []
        self.flops = 0
        self.flops_by = defaultdict(int)   # aten FLOPs by kind
        self._kernels = OPS.recording(cost=cost, into=self.ops)

    def __enter__(self):
        self._kernels.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._kernels.__exit__(*exc)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if OPS.recording_suspended():
            return out
        flat_in, _ = tree_flatten((args, kwargs))
        flat_out, _ = tree_flatten(out)
        ins = tuple(_meta(t) for t in flat_in if torch.is_tensor(t))
        outs = tuple(_meta(t) for t in flat_out if torch.is_tensor(t))
        # a view, or an op whose outputs alias its operands without
        # writing them (``_unsafe_view``, ``alias``): no bytes move
        view = bool(func.is_view) or (
            not func._schema.is_mutable and bool(outs) and all(
                o.storage in {m.storage for m in ins} for o in outs))
        self.ops.append(OpRecord(
            str(func), ins, outs,
            tuple(repr(a) for a in flat_in if not torch.is_tensor(a)), view))
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            n = flop(*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by[_kind(next(t for t in flat_in
                                     if torch.is_tensor(t)).dtype)] += n
        return out


def record_ops(fn, *args, cost: bool = True, **kw) -> list:
    """Runs ``fn(*args, **kw)`` under an ``OpRecorder``; returns its ops
    (``OpRecord``) and kernel calls (``ops.KernelCall``), in order."""
    with OpRecorder(cost=cost) as rec:
        fn(*args, **kw)
    return rec.ops


def _profile(records) -> dict:
    agg = defaultdict(lambda: {"count": 0, "bytes": 0, "moved": 0})
    for r in records:
        if isinstance(r, OPS.KernelCall):
            rec = agg[f"kernel.{r.name}"]
            rec["count"] += 1
            rec["bytes"] += r.out_bytes
            rec["moved"] += r.cost[1] if r.cost is not None \
                else r.in_bytes + r.out_bytes
            continue
        if r.view:
            continue
        out = sum(m.nbytes for m in r.outs)
        rec = agg[r.name]
        rec["count"] += 1
        rec["bytes"] += out
        rec["moved"] += out + sum(m.nbytes for m in r.ins)
    return dict(agg)


def profile_ops(fn, *args, **kw) -> dict:
    """op name -> {count, bytes, moved} of one run of ``fn(*args, **kw)``
    (module docstring): ``bytes`` the outputs' bytes (an HBM-write proxy),
    ``moved`` outputs plus operands (the bytes-touched proxy), a kernel
    call's ``moved`` its ``kernel_cost`` bytes."""
    return _profile(record_ops(fn, *args, **kw))


def bytes_moved(fn, *args, **kw) -> int:
    """Total ``moved`` of one run of ``fn``: the memory-bound cost FLOPs
    miss, a per-op upper bound (module docstring)."""
    return sum(v["moved"] for v in profile_ops(fn, *args, **kw).values())


def lowered_flops(fn, *args, **kw) -> float:
    """FLOPs of one run of ``fn(*args, **kw)`` (``count_step``): matrix
    products, convolutions and SDPA by ``torch.utils.flop_counter``'s
    formulas, each kernel call by its ``kernel_cost``; a backward that
    ``fn`` runs is counted too (a training step's plain backward replays
    are real device work)."""
    return count_step(fn, *args, **kw)["flops"]


def count_step(fn, *args, **kw) -> dict:
    """One run of ``fn``, counted: ``flops`` (``lowered_flops``),
    ``flops_by`` (kind -> FLOPs: an op's by its operands' type, a kernel
    call's by its ``kind``, for ``step_shares``), ``bytes``
    (``bytes_moved``), ``ops`` (aten operations, views included) and
    ``kernel_calls``, from one recording."""
    with OpRecorder() as rec:
        fn(*args, **kw)
    kern = [r for r in rec.ops if isinstance(r, OPS.KernelCall)]
    by = dict(rec.flops_by)
    for r in kern:
        by[r.cost[2]] = by.get(r.cost[2], 0) + r.cost[0]
    return {"flops": float(sum(by.values())), "flops_by": by,
            "bytes": sum(v["moved"] for v in _profile(rec.ops).values()),
            "ops": len(rec.ops) - len(kern), "kernel_calls": len(kern)}


def cache_read_bytes(engine) -> int:
    """Bytes of the cache tensors a ``ServingEngine``'s decode step reads:
    every leaf of its caches, whole, as each step is handed them (K and V,
    or the page pools; an int8 cache's f32 ``kscale``/``vscale`` leaves;
    the ring's ``valid`` and ``pos`` and the pool's ``pvalid``). It matches
    the JAX package's ``hloprof.cache_read_bytes`` on the compiled decode
    step: there the entry parameters that are cache leaves, matched by type
    string, which are every leaf of the engine's caches."""
    leaves, _ = tree_flatten(engine._caches)
    return tensor_bytes(*[t for t in leaves if torch.is_tensor(t)])


def biggest_tensors(records, n: int = 15) -> list:
    """The n largest single op outputs of ``record_ops``'s records as
    (bytes, op, shape text), largest first (views excluded)."""
    out = []
    for r in records:
        if isinstance(r, OPS.KernelCall):
            out.append((r.out_bytes, f"kernel.{r.name}", ""))
        elif not r.view:
            for m in r.outs:
                out.append((m.nbytes, r.name,
                            f"{str(m.dtype).replace('torch.', '')}"
                            f"{list(m.shape)}"[:90]))
    out.sort(key=lambda x: -x[0])
    return out[:n]


def top_table(prof: dict, n: int = 20) -> str:
    rows = sorted(prof.items(), key=lambda kv: -kv[1]["bytes"])[:n]
    total = sum(v["bytes"] for v in prof.values())
    lines = [f"{'op':32s} {'count':>8s} {'GB_out':>10s} {'%':>6s}"]
    for op, v in rows:
        lines.append(f"{op[:32]:32s} {v['count']:8d} {v['bytes'] / 1e9:10.2f} "
                     f"{100 * v['bytes'] / max(total, 1):6.1f}")
    lines.append(f"{'TOTAL':32s} {'':8s} {total / 1e9:10.2f}")
    return "\n".join(lines)
