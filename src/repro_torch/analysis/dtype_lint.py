"""DTYPE — silent precision and width surprises on the hot paths.

* ``DTYPE-UPCAST``: a conversion (``aten._to_copy``, ``aten.copy_``) from
  bf16 / f16 to f32 whose result is large (>= 64Ki elements) inside an
  entry point. Deliberate f32 arithmetic lives inside the kernels and
  their plain versions (which the recorder does not enter) and in small
  reductions; a large upcast outside them doubles that tensor's HBM
  traffic. Vacuous on the f32 analysis config: audit a bf16 deployment
  (``--dtype bfloat16``), as the card's smoke does.
* ``DTYPE-WIDE``: a float64 or complex128 value in an entry point (a
  Python float promoted through numpy, a stray ``.double()``): the card
  runs f64 at a fraction of the f32 rate. int64 is torch's index type
  (``argmax``, ``topk``, ``gather`` indices) and is not flagged, where the
  JAX rule flags s64.
* ``DTYPE-QUANT-HBM``: a large (>= 64Ki elements) conversion from int8 to
  a float type in a SERVING entry: an int8 cache or weight widened outside
  the kernels, which read the codes in their storage type; HBM then sees
  the wide copy. The recorder does not enter a kernel wrapper, which is
  the allowlist. A widened base weight (a tensor of the entry's params
  tree, its first argument) is reported at ``<entry>.weights``, anything
  else (a cache, an activation) at the entry. The training step is exempt
  (its weights are the config's; quantization is serving-only).
"""
from __future__ import annotations

from collections import Counter
from typing import List

import torch

from repro_torch.analysis.framework import Finding, KernelCall, leaves
from repro_torch.analysis.graphs import target

PASS_NAME = "dtype"

UPCAST_MIN_ELEMS = 64 * 1024
_NARROW = (torch.bfloat16, torch.float16)
_WIDE = (torch.float64, torch.complex128)
_CONVERT = ("aten._to_copy", "aten.copy_")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _short(m) -> str:
    return f"{str(m.dtype).replace('torch.', '')}{list(m.shape)}"


def weight_storages(ep) -> set:
    """Storages of the tensors of an entry's params tree (its first
    argument, when that is a dict: every serving entry's)."""
    if not ep.args or not isinstance(ep.args[0], dict):
        return set()
    return {t.untyped_storage().data_ptr() for _, t in leaves(ep.args[0])
            if torch.is_tensor(t)}


def findings_for(name: str, records, weights=frozenset()) -> List[Finding]:
    """The three rules over one entry's records (``weights``: the storages
    of its base weights); a finding repeated at several ops (a layer's, a
    chunk's) is reported once with its count."""
    finds = []
    serving = name != "train"
    for r in records:
        if isinstance(r, KernelCall):
            continue
        if r.name.startswith(_CONVERT) and r.outs and r.ins:
            src = r.ins[-1] if r.name.startswith("aten.copy_") else r.ins[0]
            dst = r.outs[0]
            big = _numel(dst.shape) >= UPCAST_MIN_ELEMS
            if big and src.dtype in _NARROW and dst.dtype == torch.float32:
                finds.append(Finding(
                    "DTYPE-UPCAST", target(name),
                    f"{_short(src)} -> {_short(dst)} by {r.name}: a large "
                    "activation widened to f32 (2x its HBM traffic)"))
            if big and serving and src.dtype == torch.int8 \
                    and dst.dtype.is_floating_point:
                w = src.storage in weights
                finds.append(Finding(
                    "DTYPE-QUANT-HBM", target(name) + (".weights" if w else ""),
                    f"{_short(src)} -> {_short(dst)} by {r.name}: an int8 "
                    f"{'base weight' if w else 'cache or activation'} "
                    "widened OUTSIDE the kernels; HBM sees the wide copy"))
        for m in r.outs:
            if m.dtype in _WIDE:
                finds.append(Finding(
                    "DTYPE-WIDE", target(name),
                    f"{str(m.dtype).replace('torch.', '')} value produced "
                    f"by {r.name}"))
    count = Counter((f.rule, f.message) for f in finds)
    out = []
    for f in finds:
        n = count.pop((f.rule, f.message), 0)
        if n:
            out.append(Finding(f.rule, f.target, f.message
                               + (f" (x{n})" if n > 1 else "")))
    return out


def run(bundle) -> List[Finding]:
    finds: List[Finding] = []
    for name, ep in bundle.entries().items():
        finds += findings_for(name, bundle.trace(name).records,
                              weight_storages(ep))
    return finds
