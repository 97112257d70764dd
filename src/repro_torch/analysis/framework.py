"""Finding / Report / waiver plumbing and the op recording every pass shares.

A *pass* is a function ``run(bundle) -> list[Finding]`` registered in
``repro_torch.analysis.PASSES``; the CLI (``python -m repro_torch.analysis``)
runs them over the engine's and the trainer's real entry points
(``graphs.GraphBundle``) and renders one ``Report``, as the JAX package's
``repro.analysis`` does.

Waivers: a rule is silenced per target with ``Waiver(rule, target,
reason)``: ``rule`` exact, ``target`` an fnmatch glob over the finding's
target. The CLI reads ``--waive RULE[:TARGET-GLOB]`` flags and an optional
waiver file (one ``RULE[:TARGET-GLOB]  # reason`` per line); waived
findings are reported but never fail the run.

``record_ops`` (``launch/hloprof.record_ops``) is the counterpart of the
JAX package's ``walk_eqns``: where that walks a jaxpr, this runs the entry
point under an op recorder (``hloprof.OpRecorder``) and returns its aten
operations (name,
operand and output shapes, dtypes, devices and storages, the non-tensor
arguments) and its kernel calls, in order. It does not descend into a
kernel wrapper (the wrapper reports one ``ops.KernelCall`` for its whole
call), as ``walk_eqns`` skips ``pallas_call`` sub-jaxprs: the plain
versions' f32 arithmetic is the kernels' business, and the kernels get
their own verifier (``launch_lint``).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Iterable, List

import torch

from repro_torch.kernels.ops import KernelCall
from repro_torch.launch.hloprof import OpRecord, record_ops

SEVERITIES = ("error", "warning")

__all__ = ["Finding", "Waiver", "Report", "load_waiver_file", "record_ops",
           "OpRecord", "KernelCall", "leaves", "tree_map", "get_path"]


@dataclasses.dataclass
class Finding:
    """One rule violation at one site."""
    rule: str                 # e.g. "HOST-SYNC"
    target: str               # e.g. "serve.decode" / "kernels.moe_gmm"
    message: str              # one line, human-oriented
    severity: str = "error"   # "error" fails the run; "warning" is advisory
    detail: str = ""          # optional multi-line evidence

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if not d["detail"]:
            del d["detail"]
        return d

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.target}: {self.message}"


@dataclasses.dataclass
class Waiver:
    rule: str                 # exact rule id
    target: str = "*"         # fnmatch glob over Finding.target
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        return f.rule == self.rule and fnmatch.fnmatch(f.target, self.target)

    @classmethod
    def parse(cls, text: str, reason: str = "") -> "Waiver":
        """``RULE`` or ``RULE:TARGET-GLOB``."""
        rule, _, target = text.partition(":")
        return cls(rule.strip(), target.strip() or "*", reason)


def load_waiver_file(path: str) -> List[Waiver]:
    """One waiver per line: ``RULE[:TARGET-GLOB]  # reason``. Blank lines
    and full-line comments are skipped."""
    out = []
    with open(path) as f:
        for line in f:
            body, _, comment = line.partition("#")
            body = body.strip()
            if body:
                out.append(Waiver.parse(body, reason=comment.strip()))
    return out


@dataclasses.dataclass
class Report:
    """The outcome of a set of passes over a set of entry points."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    waived: List[tuple] = dataclasses.field(default_factory=list)
    passes: List[str] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def extend(self, pass_name: str, findings: Iterable[Finding],
               waivers: Iterable[Waiver] = ()) -> None:
        """Files each finding as waived (with the first matching waiver)
        or as a finding."""
        self.passes.append(pass_name)
        waivers = list(waivers)
        for f in findings:
            w = next((w for w in waivers if w.matches(f)), None)
            if w is None:
                self.findings.append(f)
            else:
                self.waived.append((f, w))

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self, indent: int = 2) -> str:
        return json.dumps({
            "ok": self.ok,
            "passes": self.passes,
            "meta": self.meta,
            "findings": [f.to_dict() for f in self.findings],
            "waived": [dict(f.to_dict(), reason=w.reason)
                       for f, w in self.waived],
        }, indent=indent)

    def table(self, verbose: bool = False) -> str:
        lines = [f"passes run: {', '.join(self.passes) or '(none)'}"]
        for f in self.findings:
            lines.append(str(f))
            if verbose and f.detail:
                lines += ["    " + ln for ln in f.detail.splitlines()[:20]]
        for f, w in self.waived:
            lines.append(f"(waived: {w.reason or 'no reason given'}) {f}")
        n_err = len(self.errors)
        n_warn = len(self.findings) - n_err
        lines.append(f"{n_err} error(s), {n_warn} warning(s), "
                     f"{len(self.waived)} waived")
        return "\n".join(lines)


# ------------------------------ argument trees --------------------------------

def _record_like(x) -> bool:
    """A mutable dataclass instance (an ``ElasticPolicy``) is a container;
    a frozen one (a model config, an ``ElasticSpec``) is a leaf."""
    return dataclasses.is_dataclass(x) and not isinstance(x, type) \
        and not x.__dataclass_params__.frozen


def _children(x):
    """(key, child) pairs of a container, or None for a leaf: dicts, lists,
    tuples (named tuples too) and mutable dataclass instances."""
    if isinstance(x, dict):
        return list(x.items())
    if isinstance(x, (list, tuple)):
        return list(enumerate(x))
    if _record_like(x):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    return None


def leaves(tree, prefix=()) -> list:
    """[(key path, leaf)] of a nested argument tree, containers expanded
    (configs and other objects are leaves)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [p for k, v in kids for p in leaves(v, prefix + (k,))]


def tree_map(fn, tree):
    """The tree rebuilt with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    if _record_like(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


def get_path(args: tuple, kwargs: dict, path: tuple):
    """The value at ``path`` (an argument index or keyword, then keys)."""
    node = kwargs[path[0]] if isinstance(path[0], str) else args[path[0]]
    for k in path[1:]:
        node = getattr(node, k) if _record_like(node) else node[k]
    return node


def clone_tensors(tree):
    return tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, tree)
