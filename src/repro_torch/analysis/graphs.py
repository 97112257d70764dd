"""The real entry points every analysis pass lints.

``build_bundle()`` stands up a config exactly the way production does:
``ServingEngine`` (ring and paged) for the admission, chunk and decode
entry points, ``make_train_step`` for the training step, on the card
unless ``device="cpu"``. Passes never invent their own call signatures:
the serving arguments come from ``ServingEngine.entry_points()``, built by
the code paths a live call uses, so a refactor that changes the contract
changes what gets linted. The counterpart of the JAX package's
``analysis/graphs.py``, without the mesh (one card; the mesh's passes,
``sharding_lint`` among them, are ROADMAP item 14).

An entry point is recorded once (``GraphBundle.trace``): it runs on copies
of the tensors it writes in place (the engine's own buffers stay as they
were) under the op recorder, and the trace keeps, for each declared
in-place tensor, whether it kept its storage and whether its version
counter moved.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis.framework import (clone_tensors, get_path, leaves,
                                            record_ops)
from repro_torch.configs import get_config, get_elastic
from repro_torch.core.policy import as_spec_policy, ragged_bucket, solve_budget
from repro_torch.device import resolve_device
from repro_torch.models import model_init, router_init
from repro_torch.training import ServingEngine
from repro_torch.training.serve import EntryPoint
from repro_torch.training.train_step import init_train_state, make_train_step


class InplaceCheck(NamedTuple):
    path: tuple
    same_storage: bool
    version_moved: bool
    storage: int          # the tensor's storage pointer before the call
    shape: tuple
    dtype: torch.dtype


class Trace(NamedTuple):
    """One recorded call of an entry point: its ops and kernel calls
    (``framework.record_ops``) and its ``InplaceCheck``s."""
    records: list
    inplace: list


def call_entry(ep: EntryPoint, args: Optional[tuple] = None,
               kwargs: Optional[dict] = None, grad: bool = False) -> Trace:
    """Runs ``ep`` once on copies of its in-place arguments (or on the
    given ``args``/``kwargs``) under the op recorder; returns a ``Trace``.
    A serving entry runs under ``torch.no_grad`` as the engine runs it;
    ``grad``: the training step, which computes its own gradients."""
    args = ep.args if args is None else args
    kwargs = ep.kwargs if kwargs is None else kwargs
    roots = {p[0] for p in ep.inplace}
    args = tuple(clone_tensors(a) if i in roots else a
                 for i, a in enumerate(args))
    kwargs = {k: clone_tensors(v) if k in roots else v
              for k, v in kwargs.items()}
    before = []
    for path in ep.inplace:
        for sub, t in leaves(get_path(args, kwargs, path)):
            if torch.is_tensor(t):
                before.append((path + sub, t, t.untyped_storage().data_ptr(),
                               t._version))
    with torch.enable_grad() if grad else torch.no_grad():
        records = record_ops(ep.fn, *args, cost=False, **kwargs)
    checks = []
    for path, t, ptr, version in before:
        now = get_path(args, kwargs, path)
        checks.append(InplaceCheck(
            path, torch.is_tensor(now) and
            now.untyped_storage().data_ptr() == ptr, t._version != version,
            ptr, tuple(t.shape), t.dtype))
    return Trace(records, checks)


@dataclasses.dataclass
class GraphBundle:
    """Entry points + a shared trace cache."""
    cfg: object
    spec: object
    params: object
    rp: object
    engine: Optional[ServingEngine]
    paged_engine: Optional[ServingEngine] = None
    device: torch.device = torch.device("cpu")
    seq_len: int = 32
    train_batch: int = 4
    _entries: Optional[dict] = None
    _traces: dict = dataclasses.field(default_factory=dict)

    def entries(self) -> dict:
        """{name: EntryPoint}: the ring engine's ``admit`` and ``decode``,
        the paged engine's as ``paged_chunk`` and ``paged_decode``, and
        ``train``."""
        if self._entries is None:
            self._entries = dict(self.engine.entry_points())
            if self.paged_engine is not None:
                for k, ep in self.paged_engine.entry_points().items():
                    self._entries[f"paged_{k}"] = ep
            self._entries["train"] = self._train_entry()
        return self._entries

    def _train_entry(self) -> EntryPoint:
        spec, _ = as_spec_policy(self.spec)
        step = make_train_step(self.cfg, spec, lr=1e-3,
                               chunked=self.cfg.vocab_size > 0)
        state = init_train_state(self.rp)
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, max(2, self.cfg.vocab_size),
            size=(self.train_batch, self.seq_len)), dtype=torch.int64,
            device=self.device)}
        pol = solve_budget(self.cfg, spec, 0.5)    # as launch/train.py
        bucket = (ragged_bucket(pol, self.seq_len, spec=spec)
                  if spec.routing_impl == "ragged" else None)
        return EntryPoint(step, (state, self.params, batch,
                                 pol.to(self.device)), {"bucket": bucket})

    def trace(self, name: str) -> Trace:
        if name not in self._traces:
            self._traces[name] = call_entry(self.entries()[name],
                                            grad=name == "train")
        return self._traces[name]


def target(name: str) -> str:
    """A finding's target for entry ``name``."""
    return "train.step" if name == "train" else f"serve.{name}"


def build_bundle(device=None, arch: str = "toy-lm", kv_dtype: str = "fp32",
                 weight_dtype: str = "fp32", depth: bool = True,
                 mode: str = "infer", variant: str = "smoke",
                 n_layers: Optional[int] = None,
                 dtype: Optional[str] = "float32", spec=None,
                 max_seq: int = 48, seq_len: int = 32, page_size: int = 8,
                 seed: int = 0) -> GraphBundle:
    """Stand up an arch's serving and training entry points (the toy
    config in f32 by default, as the JAX package's analysis runs it).
    ``kv_dtype`` / ``weight_dtype`` build the SERVING engines quantized so
    the dtype pass audits the int8 paths (the training step runs the
    config's weights); ``depth`` adds the elastic depth router so the
    linted steps carry its per-layer validity writes; ``variant`` /
    ``n_layers`` / ``dtype`` pick and cut the config (``dtype`` None keeps
    the config's); ``spec`` replaces the arch's elastic config. A paged
    engine joins when every layer is global attention with a dense MLP."""
    dev = resolve_device(device)
    cfg = get_config(arch, variant)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    ecfg = spec if spec is not None else get_elastic(arch, cfg)
    if depth and getattr(ecfg, "depth_capacity", 0) is None:
        ecfg = dataclasses.replace(ecfg, depth_capacity=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_init(gen, cfg, ecfg, device=dev)
    rp = router_init(gen, cfg, ecfg, device=dev)
    engine = ServingEngine(params, rp, cfg, ecfg, mode=mode, batch_size=2,
                           max_seq=max_seq, device=dev, kv_dtype=kv_dtype,
                           weight_dtype=weight_dtype)
    paged_engine = None
    if all(k == "attn" for k in cfg.layer_kinds) and cfg.moe is None \
            and cfg.encoder is None and not any(cfg.layer_windows) \
            and not getattr(ecfg, "mlp_n_experts", None) and mode != "train":
        paged_engine = ServingEngine(params, rp, cfg, ecfg, mode=mode,
                                     batch_size=2, max_seq=max_seq,
                                     device=dev, kv_layout="paged",
                                     page_size=page_size, kv_dtype=kv_dtype,
                                     weight_dtype=weight_dtype)
    return GraphBundle(cfg, ecfg, params, rp, engine,
                       paged_engine=paged_engine, device=dev,
                       seq_len=seq_len)


__all__ = ["GraphBundle", "build_bundle", "call_entry", "Trace",
           "InplaceCheck", "target"]
