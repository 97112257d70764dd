"""LAUNCH — static verification of every kernel call's launch geometry.

The counterpart of the JAX package's ``pallas_lint``. Where that records
each ``pallas_call``'s grid and BlockSpecs, this reads each call's
``ops.launch_geometry``: the grid, block, dynamic shared memory and tiles
the C launcher will use, stated in Python from the plans the wrapper
hands it (on the card ``chip_smoke.py`` holds that statement to each
launcher's own ``*_geometry`` report). It runs over one representative
call per kernel form (``kernels.analyzable_kernels()``) and over every
kernel call the entry points record:

* ``LAUNCH-OOB``: every tile the grid indexes starts inside its operand,
  the tiles cover it, and the grid is within the card's limits (y and z
  at most 65535). A tile outside reads or writes another tensor's bytes.
* ``LAUNCH-ALIGN`` (a warning): a bf16 MLP-mode call (``fused_mlp``,
  ``fused_mlp_routed``, ``moe_gmm``) on the CUDA-core body because D, F
  or Fe is no multiple of 64: the tensor cores sit idle (RecurrentGemma's
  480-wide experts, PERF.md row 4h).
* ``LAUNCH-SMEM``: the dynamic shared memory of a block is at most 227
  KiB, what a block may have on the H100.
* ``LAUNCH-CONTROL`` (``PAL-PREFETCH``'s counterpart): the integer control
  vectors a decode kernel reads (ring positions and t, the page table and
  t) reach the wrapper as contiguous int32 on the kernel's device, so it
  hands them over without a per-call copy (``ops._int32``).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.framework import Finding, KernelCall
from repro_torch.analysis.graphs import target
from repro_torch.kernels import ops

PASS_NAME = "launch"

GRID_YZ_MAX = 65535
CONTROL = {"decode_attention": ("kv_pos", "t"),
           "paged_decode_attention": ("table", "t")}
MLP_MODES = ("fused_mlp", "fused_mlp_routed", "moe_gmm")


def verify_call(tgt: str, name: str, args: dict, geo: dict) -> List[Finding]:
    """The four gates over one call (``args`` by name, ``geo`` its
    ``launch_geometry``); exposed so tests can feed a bad geometry."""
    finds = []
    for l in geo["launches"]:
        gx, gy, gz = l["grid"]
        if min(l["grid"]) < 1 or gy > GRID_YZ_MAX or gz > GRID_YZ_MAX:
            finds.append(Finding(
                "LAUNCH-OOB", tgt, f"{l['kernel']} grid {l['grid']} is "
                f"empty or past the card's y/z limit {GRID_YZ_MAX}"))
        if l["smem"] > ops.SMEM_LIMIT:
            finds.append(Finding(
                "LAUNCH-SMEM", tgt, f"{l['kernel']} asks {l['smem']} bytes "
                f"of shared memory a block, past {ops.SMEM_LIMIT}"))
    for operand, dims, tile, n in geo["tiles"]:
        for axis, (d, t, k) in enumerate(zip(dims, tile, n)):
            if d and ((k - 1) * t >= d or k * t < d):
                finds.append(Finding(
                    "LAUNCH-OOB", tgt,
                    f"{operand} {list(dims)}: {k} tiles of {t} along axis "
                    f"{axis} " + ("start past its end" if (k - 1) * t >= d
                                  else "leave rows uncovered")))
    if name in MLP_MODES and geo["body"] == "cuda_core" \
            and args["x"].dtype == torch.bfloat16:
        D, F = args["x"].shape[-1], args["wi"].shape[-1]
        if D % 64 or F % 64:
            finds.append(Finding(
                "LAUNCH-ALIGN", tgt,
                f"bf16 {name} at D {D}, F {F}: no multiple of 64, so the "
                "CUDA-core body runs (the tensor cores idle)",
                severity="warning"))
    act = args["q"] if "q" in args else None
    for key in CONTROL.get(name, ()):
        v = args[key]
        if not (torch.is_tensor(v) and v.dtype == torch.int32
                and v.is_contiguous() and v.device == act.device):
            what = (f"{v.dtype} on {v.device}{'' if v.is_contiguous() else ', strided'}"
                    if torch.is_tensor(v) else type(v).__name__)
            finds.append(Finding(
                "LAUNCH-CONTROL", tgt,
                f"{name}'s {key} arrives as {what}: the wrapper copies it "
                "to contiguous int32 on the card on every call"))
    return finds


def check_call(tgt: str, call: KernelCall) -> List[Finding]:
    return verify_call(tgt, call.name, call.args,
                       ops.launch_geometry(call.name, **call.args))


def run(bundle) -> List[Finding]:
    from repro_torch.kernels import analyzable_kernels
    finds: List[Finding] = []
    for name, build in analyzable_kernels().items():
        kernel, args, kwargs = build(bundle.device)
        with ops.recording(cost=False) as calls:
            kernel(*args, **kwargs)
        for c in calls:
            finds += check_call(f"kernels.{name}", c)
    for name in bundle.entries():
        seen = set()
        for r in bundle.trace(name).records:
            if isinstance(r, KernelCall):
                for f in check_call(f"calls.{target(name)}.{r.name}", r):
                    if (f.rule, f.message) not in seen:
                        seen.add((f.rule, f.message))
                        finds.append(f)
    return finds
