"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, from the sources in this package and
nothing else, into its own shared library with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``). The libraries
land in ``_build/<hash>/`` next to this file (listed in ``.gitignore``),
where the hash covers every source and the flags: a changed source builds
anew, an unchanged one loads what is there. All compilations start
together, one ``nvcc`` per source. Nothing builds at import time: the first
kernel launch calls ``load``, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention", "fused_mlp", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> (source, signature) (see each .cu file)
ENTRIES = {
    "flash_attention_launch": ("flash_attention", [
        _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
        _P]),
    "fused_mlp_launch": ("fused_mlp", [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _I, _P]),
    "fused_mlp_routed_launch": ("fused_mlp", [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
        _I, _I, _I, _P]),
    "decode_attention_launch": ("decode_attention", [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _I, _I, _I, _F, _P]),
    "paged_decode_attention_launch": ("decode_attention", [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _I, _I, _I, _F, _P]),
    "fused_mlp_tc_launch": ("fused_mlp", [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
        _I, _I, _I, _I, _I, _P]),
    "moe_gmm_launch": ("fused_mlp", [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _P]),
    "moe_gmm_tc_launch": ("fused_mlp", [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
}
# each launcher's geometry query: its arguments but the stream, then an int
# array for the record (csrc/common.cuh rt::geometry_out)
ENTRIES.update({
    name.replace("_launch", "_geometry"): (src, sig[:-1] + [
        ctypes.POINTER(ctypes.c_int)])
    for name, (src, sig) in list(ENTRIES.items())})

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}   # kernel name -> nvcc's output (registers, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building every source first
    if the current sources have not been built yet."""
    with _lock:
        if name in _libs:
            return _libs[name]
        out_dir = BUILD_ROOT / source_hash()
        if not all((out_dir / f"lib{n}.so").exists() for n in SOURCES):
            _build_all(out_dir)
        for n in SOURCES:
            _libs[n] = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
        for entry, (src, sig) in ENTRIES.items():
            fn = getattr(_libs[src], entry)
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        return _libs[name]


def build() -> float:
    """Build (or find) and load every source; returns the seconds taken."""
    t0 = time.perf_counter()
    load(SOURCES[0])
    return time.perf_counter() - t0
