"""INPLACE — the tensors an entry point must write in place keep their
storage, and no whole cache is copied.

The engine's caches, tokens and policy are allocated once and never
rebound (``training/serve.py``): a captured decode graph reads and writes
those storages, so a step that rebinds a cache leaf to a new tensor, or
copies a whole cache to change a row, breaks the graph or doubles the
cache's traffic. The counterparts of the JAX package's ``DONATE-*``
rules (``EntryPoint.inplace`` is ``donated``):

* ``INPLACE-MISSING`` (``DONATE-DEAD``'s counterpart): after one call on
  copies, every declared tensor is still the same storage at its path,
  and its version counter moved (the call wrote it).
* ``INPLACE-COPY`` (``DONATE-MISSING``'s): no recorded operation outputs a
  tensor of a declared cache leaf's size and dtype (a declared tensor
  under a cache's ``layers``) in another storage: a whole-cache copy (a
  functional scatter, a ``clone``, a ``torch.where`` over the whole
  leaf). The small declared buffers (the tokens, a chunk's logits) are
  written by copying a step's result into them, by design.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.framework import Finding, KernelCall
from repro_torch.analysis.graphs import target

PASS_NAME = "donation"


def missing(name: str, trace) -> List[Finding]:
    bad = [c for c in trace.inplace
           if not (c.same_storage and c.version_moved)]
    if not bad:
        return []
    why = lambda c: ("rebound to another tensor" if not c.same_storage
                     else "not written")
    return [Finding(
        "INPLACE-MISSING", target(name),
        f"{len(bad)}/{len(trace.inplace)} declared in-place tensors were "
        f"not written in place: " + ", ".join(
            f"{c.path[1:]} ({why(c)})" for c in bad[:4]),
        detail="\n".join(f"{c.path}: {why(c)}" for c in bad))]


def copies(name: str, trace) -> List[Finding]:
    mine = {c.storage for c in trace.inplace}
    sizes = {}
    for c in trace.inplace:
        if "layers" not in c.path:
            continue
        n = 1
        for d in c.shape:
            n *= d
        sizes.setdefault((n, c.dtype), c.path)
    finds = []
    for r in trace.records:
        if isinstance(r, KernelCall) or r.view:
            continue
        for m in r.outs:
            n = 1
            for d in m.shape:
                n *= d
            path = sizes.get((n, m.dtype))
            if path is not None and n > 1 and m.storage not in mine:
                finds.append(Finding(
                    "INPLACE-COPY", target(name),
                    f"{r.name} outputs a {str(m.dtype).replace('torch.', '')}"
                    f"{list(m.shape)} outside the cache: a whole copy of "
                    f"{path[1:]}; write the rows in place"))
    return finds


def run(bundle) -> List[Finding]:
    finds: List[Finding] = []
    for name, ep in bundle.entries().items():
        if not ep.inplace:
            continue
        trace = bundle.trace(name)
        finds += missing(name, trace)
        finds += copies(name, trace)
    return finds
