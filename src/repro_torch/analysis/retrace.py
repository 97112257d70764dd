"""RETRACE — prove a captured entry point cannot change under new values.

On the card the engine captures its decode step and its paged prefill
chunk into CUDA graphs once per form and replays them: a replay repeats
the captured operations whatever the buffers hold. So the serving SLO
("budgets, slots, temperatures, seeds never add a form") is a property of
the recorded op sequence, checkable without the card:

* ``RETRACE-VALUE-DEP``: record each graphed entry point twice, with every
  numeric leaf perturbed within its form (floats times 1.5, so a
  temperature stays on its side of 0; positive integers one lower, so
  positions, tokens and page ids stay in range and -1 sentinels stay;
  bools as they are), and diff the normalised op sequences (op names,
  shapes, dtypes, the non-tensor arguments; kernel calls by their
  arguments' shapes). A difference means a value reached the host (an
  ``int(x)``, an ``if x:``) and the captured graph would replay the
  first call's choice. Eager entries (the ring admission, the training
  step) run their operations anew each call and are not checked.
* ``RETRACE-PY-SCALAR``: a Python number in a graphed entry's arguments,
  which the capture bakes in.
* ``RETRACE-COMPILE-COUNT``: a live mixed workload (two budgets, greedy and
  sampling, two seeds) on the ring engine and four prompt lengths (3, 8,
  13, 21) on the paged one, held to the engine's documented contract
  (``ServingEngine.compile_counts``): ring prefill 0 and at most two
  decode forms; paged prefill exactly 1 and at most two decode forms.

The JAX package's ``RETRACE-WEAK-TYPE`` and ``RETRACE-STATIC-UNHASHABLE``
have no counterpart: a torch tensor has no weak type, and an entry point
takes no static (hashed, compile-time) arguments.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.analysis.framework import (Finding, KernelCall, leaves,
                                            tree_map)
from repro_torch.analysis.graphs import call_entry, target

PASS_NAME = "retrace"


def perturb(leaf):
    """The same shape, dtype and form, another value (module docstring)."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bool:
            return leaf
        if leaf.is_floating_point():
            return leaf * 1.5
        return torch.where(leaf > 0, leaf - 1, leaf)
    if isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
        return leaf + 1
    return leaf


def normalize(records) -> list:
    """An op sequence without storages and values: what a capture fixes."""
    out = []
    for r in records:
        if isinstance(r, KernelCall):
            out.append((r.name, tuple(
                (k, tuple(v.shape), v.dtype) if torch.is_tensor(v) else
                (k, repr(v)) for k, v in r.args.items())))
        else:
            out.append((r.name, tuple((m.shape, m.dtype) for m in r.ins),
                        tuple((m.shape, m.dtype) for m in r.outs),
                        r.scalars))
    return out


def _diff_head(a: list, b: list, n: int = 4) -> str:
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            out.append(f"op {i}:\n  - {str(x)[:160]}\n  + {str(y)[:160]}")
            if len(out) >= n:
                break
    if len(a) != len(b):
        out.append(f"op counts differ: {len(a)} vs {len(b)}")
    return "\n".join(out)


def _lint_args(name: str, ep) -> List[Finding]:
    if not ep.graphed:
        return []
    finds = []
    for path, leaf in leaves((ep.args, ep.kwargs)):
        if isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
            finds.append(Finding(
                "RETRACE-PY-SCALAR", target(name),
                f"argument {path[1:]} is a Python {type(leaf).__name__}: "
                "the captured graph bakes its value in; pass a 0-d device "
                "tensor"))
    return finds


def value_dep(name: str, ep, base=None) -> List[Finding]:
    """RETRACE-VALUE-DEP of one graphed entry (``base``: its trace, when
    recorded already)."""
    if not ep.graphed:
        return []
    base = base if base is not None else call_entry(ep)
    other = call_entry(ep, tree_map(perturb, ep.args),
                       tree_map(perturb, ep.kwargs))
    a, b = normalize(base.records), normalize(other.records)
    if a != b:
        return [Finding(
            "RETRACE-VALUE-DEP", target(name),
            "the op sequence changed when only argument VALUES changed: a "
            "value reaches the host, and a captured graph replays the "
            "first call's choice", detail=_diff_head(a, b))]
    return []


def _drain(engine, steps: int) -> None:
    for _ in range(steps):
        if not engine.has_work:
            break
        engine.step()


def workload(bundle) -> List[Finding]:
    """Live retrace probe on the bundle's engines (module docstring)."""
    from repro_torch.training.serve import GenRequest
    finds = []
    eng = bundle.engine
    prompt = np.arange(1, 9, dtype=np.int32)
    for i, (budget, temp) in enumerate([(0.5, 0.0), (0.75, 0.8)]):
        eng.submit(GenRequest(prompt, max_new_tokens=3, budget=budget,
                              temperature=temp, top_k=2 * i, seed=7 * i))
    _drain(eng, 24)
    got = eng.compile_counts()
    if got["prefill"] != 0 or got["decode"] > 2:
        finds.append(Finding(
            "RETRACE-COMPILE-COUNT", "serve.engine",
            f"compile_counts {got} over a 2-budget mixed-sampling workload; "
            "the ring engine keeps prefill 0 (eager admission) and at most "
            "two decode forms (greedy-only, sampling)"))
    peng = bundle.paged_engine
    if peng is not None:
        for i, plen in enumerate((3, 8, 13, 21)):
            peng.submit(GenRequest(np.arange(1, plen + 1, dtype=np.int32),
                                   max_new_tokens=2, budget=0.5 + 0.1 * i))
        _drain(peng, 48)
        got = peng.compile_counts()
        if got["prefill"] != 1 or got["decode"] > 2:
            finds.append(Finding(
                "RETRACE-COMPILE-COUNT", "serve.paged_engine",
                f"paged compile_counts {got} over 4 prompt lengths; one "
                "captured chunk serves every length (prefill exactly 1, at "
                "most two decode forms)"))
    return finds


def run(bundle) -> List[Finding]:
    finds: List[Finding] = []
    for name, ep in bundle.entries().items():
        finds += _lint_args(name, ep)
        if ep.graphed:
            finds += value_dep(name, ep, bundle.trace(name))
    finds += workload(bundle)
    return finds
