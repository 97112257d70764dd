"""HOST — device-to-host synchronisation on the serving and training paths.

* ``HOST-SYNC``: an operation inside an entry point that makes the host
  wait for the card: ``aten._local_scalar_dense`` (``int(t)``,
  ``t.item()``), ``aten.is_nonzero`` (``if t:``), an output whose size
  depends on the data (``nonzero``, ``masked_select``, ``unique``, boolean
  indexing), or a copy from the card to the CPU. One finding per entry
  point, with the count of such operations and where they come from; on
  the CPU the same operations are recorded (they would wait on the card).
  A captured graph cannot hold one (the capture raises), so this is a
  finding of the eager entries: the ring admission's count is the host
  cost that bounds its wall time (waived with that reason, per entry).
* ``HOST-OPERAND``: a numpy array, or (an entry on the card) a CPU tensor,
  among an entry point's arguments: re-uploaded on every call; serving
  state must live on the device between steps.

The JAX package's ``HOST-CALLBACK`` (a host callback inside a jitted graph)
is this ``HOST-SYNC``: eager PyTorch has no callbacks, only operations that
wait for the device.
"""
from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np
import torch

from repro_torch.analysis.framework import Finding, KernelCall, leaves
from repro_torch.analysis.graphs import target

PASS_NAME = "host_sync"

SYNC_OPS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.item",
            "aten.nonzero.", "aten.masked_select", "aten.unique",
            "aten._unique", "aten.unique_consecutive")


def sync_ops(records) -> Counter:
    """op name -> how many times it made the host wait (module docstring)."""
    out = Counter()
    for r in records:
        if isinstance(r, KernelCall):
            continue
        name = r.name
        if name.startswith(SYNC_OPS):
            out[name] += 1
        elif name.startswith("aten.index.Tensor") and any(
                m.dtype == torch.bool for m in r.ins[1:]):
            out[name + " (bool mask)"] += 1
        elif name.startswith(("aten._to_copy", "aten.copy_")) and r.outs \
                and r.ins and r.outs[0].device == "cpu" and any(
                    m.device == "cuda" for m in r.ins):
            out[name + " (to the CPU)"] += 1
    return out


def syncs(bundle, name: str) -> List[Finding]:
    count = sync_ops(bundle.trace(name).records)
    if not count:
        return []
    n = sum(count.values())
    return [Finding(
        "HOST-SYNC", target(name),
        f"{n} host sync(s) per call: "
        + ", ".join(f"{k} x{v}" for k, v in count.most_common()),
        detail="\n".join(f"{k}: {v}" for k, v in count.most_common()))]


def host_operands(name: str, ep, device) -> List[Finding]:
    finds = []
    for path, leaf in leaves((ep.args, ep.kwargs)):
        if isinstance(leaf, np.ndarray):
            finds.append(Finding(
                "HOST-OPERAND", target(name),
                f"argument {path[1:]} ({leaf.dtype}{list(leaf.shape)}) is a "
                "numpy array: uploaded on every call; keep it on the device"))
        elif torch.is_tensor(leaf) and torch.device(device).type == "cuda" \
                and leaf.device.type == "cpu":
            finds.append(Finding(
                "HOST-OPERAND", target(name),
                f"argument {path[1:]} ({leaf.dtype}{list(leaf.shape)}) is a "
                "CPU tensor in an entry on the card: copied on every call"))
    return finds


def run(bundle) -> List[Finding]:
    finds: List[Finding] = []
    for name, ep in bundle.entries().items():
        finds += syncs(bundle, name)
        finds += host_operands(name, ep, bundle.device)
    return finds
