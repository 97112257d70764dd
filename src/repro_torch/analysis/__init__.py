"""repro_torch.analysis — static lint of the port's serving and training
entry points and kernel launches.

``python -m repro_torch.analysis --device cpu`` builds the real toy-config
entry points (``graphs.build_bundle``: the ring engine's admission and
decode, the paged engine's chunk and decode, the training step) and runs
every registered pass over them. The rule catalog, rule by rule against
the JAX package's ``repro.analysis``:

    retrace    RETRACE-VALUE-DEP      RETRACE-VALUE-DEP (graphed entries)
               RETRACE-PY-SCALAR      RETRACE-PY-SCALAR (graphed entries)
               RETRACE-COMPILE-COUNT  RETRACE-COMPILE-COUNT (the port's
                                      contract: ring prefill 0, paged 1,
                                      decode at most 2 forms)
               -                      RETRACE-WEAK-TYPE, RETRACE-STATIC-
                                      UNHASHABLE (no torch counterpart)
    host_sync  HOST-SYNC              HOST-CALLBACK
               HOST-OPERAND           HOST-OPERAND (+ CPU tensors on the card)
    donation   INPLACE-MISSING        DONATE-DEAD
               INPLACE-COPY           DONATE-MISSING
    dtype      DTYPE-UPCAST           DTYPE-UPCAST
               DTYPE-WIDE             DTYPE-WIDE (f64 and c128; int64 is
                                      torch's index type)
               DTYPE-QUANT-HBM        DTYPE-QUANT-HBM (int8 to any float)
    launch     LAUNCH-OOB             PAL-OOB
               LAUNCH-ALIGN           PAL-ALIGN (tensor-core widths)
               LAUNCH-SMEM            (VMEM limits: shared memory a block)
               LAUNCH-CONTROL         PAL-PREFETCH
    -          SHARD-CACHE-WRITE, SHARD-DONATED-OUT: wait for ROADMAP item
               11 (a mesh; on one card they are vacuous)

Each pass is ``run(bundle) -> list[Finding]``; add a pass by appending to
``PASSES``. Waivers (``--waive RULE[:TARGET-GLOB]``, a waiver file, and
the package's own ``WAIVERS``, each with its reason) silence known
findings without hiding them from the report.
"""
from repro_torch.analysis import (donation, dtype_lint, host_sync,
                                  launch_lint, retrace)
from repro_torch.analysis.framework import (Finding, Report, Waiver,
                                            load_waiver_file)
from repro_torch.analysis.graphs import GraphBundle, build_bundle

PASSES = [
    (retrace.PASS_NAME, retrace.run),
    (host_sync.PASS_NAME, host_sync.run),
    (donation.PASS_NAME, donation.run),
    (dtype_lint.PASS_NAME, dtype_lint.run),
    (launch_lint.PASS_NAME, launch_lint.run),
]

# The package's known findings, each with the reason it stands (PERF.md
# §5 names the bottlenecks).
WAIVERS = [
    Waiver("LAUNCH-CONTROL", "calls.serve.paged_chunk.paged_decode_attention",
           "a prefill chunk's query rows share one page-table row, broadcast "
           "(stride 0): the wrapper makes the (C, P) int32 table the kernel "
           "reads, C * P * 4 bytes a layer"),
    Waiver("DTYPE-QUANT-HBM", "serve.*.weights",
           "int8 weights are widened to the activation dtype for the plain "
           "projection and decode-MLP products outside the kernels: PERF.md "
           "bottleneck (1), the int8 decode step's weight widening"),
    Waiver("DTYPE-UPCAST", "train.step",
           "the training step computes in f32 where the reference does: "
           "the distillation loss's log-softmax over the vocabulary "
           "(training/train_step.py::_chunk_kl), the norms' statistics, and "
           "the kernels' plain backward replays (ops.KernelOp), whose f32 "
           "weights and activations are PERF.md bottleneck (3)"),
    Waiver("LAUNCH-ALIGN", "kernels.moe_gmm_bf16_narrow",
           "the representative call of an expert width that is no multiple "
           "of 64 (RecurrentGemma's 480): the CUDA-core body, PERF.md row "
           "4h"),
]

__all__ = ["Finding", "Report", "Waiver", "load_waiver_file", "GraphBundle",
           "build_bundle", "PASSES", "WAIVERS", "run_all"]


def run_all(bundle=None, waivers=(), only=None, device=None) -> Report:
    """Run every registered pass (or the ``only`` subset) over ``bundle``
    (default: the toy bundle on ``device``) and fold the findings into one
    Report, the package's ``WAIVERS`` with ``waivers``."""
    if bundle is None:
        bundle = build_bundle(device=device)
    report = Report(meta={
        "device": str(bundle.device),
        "arch": bundle.cfg.name,
        "dtype": bundle.cfg.dtype,
        "entries": sorted(bundle.entries()),
    })
    for name, fn in PASSES:
        if only and name not in only:
            continue
        report.extend(name, fn(bundle), list(waivers) + WAIVERS)
    return report
