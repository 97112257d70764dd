"""Fault-tolerant checkpointing: async, atomic, content-verified, keep-N.

Layout:  <dir>/step_<step:010d>/  shard_<host>.npz  + manifest.json
 - writes go to step_<n>.tmp<host> then os.replace (atomic on POSIX) — a
   crash mid-save never corrupts the latest checkpoint;
 - the manifest carries the step, the caller's ``extra`` and a
   ``zlib.crc32`` per array, so restore detects torn writes;
 - saves run on a background thread (training never blocks on disk);
 - ``latest_step`` / ``restore`` implement restart-from-failure, and
   restore places the tensors on a given device.

This is the JAX package's ``checkpoint/checkpointer.py``, copied so that
the port depends on nothing of that package, and it writes the same files:
the npz keys are JAX's ``keystr`` paths (``['router']['scan'][0]['w']``)
of nested dicts (keys in sorted order, as JAX flattens them), lists and
tuples, whose leaves are tensors or numpy arrays. A JAX checkpoint is
therefore a port checkpoint and the other way round. numpy has no
bfloat16 without ``ml_dtypes`` (the card's machine has none), so a bf16
leaf is written widened to f32, which is exact, and narrowed back to the
dtype of the ``tree_like`` leaf on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch


def _snapshot(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that no later in-place write can reach (on
    the CPU, ``t.cpu()`` would return the same storage)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:       # numpy has no bf16: widen exactly
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _walk(tree, prefix: str, leaf_fn, out: dict) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{prefix}['{k}']", leaf_fn, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, f"{prefix}[{i}]", leaf_fn, out)
    elif tree is not None:                  # None: an empty subtree, as JAX
        out[prefix] = leaf_fn(tree)


def flatten(tree) -> dict:
    """``{keystr: ndarray}`` of ``tree``, each leaf a host copy: the keys
    and arrays JAX's checkpointer writes for the same tree."""
    out: dict = {}
    _walk(tree, "", _snapshot, out)
    return out


def _rebuild(tree_like, arrays: dict, device, prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _rebuild(v, arrays, device, f"{prefix}['{k}']")
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        out = [_rebuild(v, arrays, device, f"{prefix}[{i}]")
               for i, v in enumerate(tree_like)]
        return out if isinstance(tree_like, list) else type(tree_like)(out)
    if tree_like is None:
        return None
    if prefix not in arrays:
        raise ValueError(f"checkpoint has no array at {prefix}")
    a = arrays[prefix]
    if tuple(a.shape) != tuple(tree_like.shape):
        raise ValueError(f"checkpoint shape mismatch at {prefix}: "
                         f"{tuple(a.shape)} != {tuple(tree_like.shape)}")
    if not isinstance(tree_like, torch.Tensor):
        return a
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):  # bf16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if tree_like.dtype == torch.bfloat16 and t.dtype == torch.float32:
        t = t.to(torch.bfloat16)            # a widened bf16 leaf: exact
    return t.to(tree_like.device if device is None else device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host: int = 0):
        self.dir = directory
        self.keep = keep
        self.host = host
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------ save --------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot ``tree`` now (every leaf copied to host memory before
        this returns), write it on a background thread."""
        arrays = flatten(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, arrays, extra or {}), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: dict, extra: dict):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + f".tmp{self.host}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.host}.npz"), **arrays)
        manifest = {
            "step": step,
            "extra": extra,
            "checksums": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                          for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ----------------------------- restore ------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(tuple(
                    f".tmp{i}" for i in range(1024))):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, tree_like: Any, device=None):
        """Load checkpoint ``step`` shaped like ``tree_like``; verify every
        checksum (``IOError`` on a mismatch); a missing key or a shape that
        differs raises ``ValueError`` naming the key. A tensor leaf of
        ``tree_like`` comes back as a tensor of its dtype on ``device``
        (None: the leaf's own device), a numpy leaf as the stored array.
        Returns (tree, extra)."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, f"shard_{self.host}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        for k, v in arrays.items():
            crc = zlib.crc32(np.ascontiguousarray(v).tobytes())
            if crc != manifest["checksums"][k]:
                raise IOError(f"checkpoint corruption at {k} (crc mismatch)")
        return _rebuild(tree_like, arrays, device), manifest["extra"]
