"""Public wrappers of the port's hand-written CUDA kernels.

One wrapper per kernel, with the signature of its counterpart in the JAX
package's ``kernels/ops.py``. ``backend``:

  * ``"auto"``/None — the tensors' device decides: a CPU tensor goes to the
    kernel's plain PyTorch version (``kernels/ref.py``), a CUDA tensor
    launches the kernel or raises;
  * ``"cuda"``      — the kernel; a CPU tensor raises;
  * ``"ref"``       — the plain version on any device.

There is no fallback: a build failure, a refused launch or an unsupported
shape raises. Each wrapper adds one to its count in ``launch_counts()``
exactly when it launches its kernel; a call captured into a CUDA graph
(the serving engine's entry points) counts once per replay of the graph
instead (``captured_launches``, ``count_replay``).

Quantized operands (the serving engine's ``kv_dtype`` / ``weight_dtype``,
``models/quant.py``): a weight, K or V tensor arrives in its storage dtype
(the activation dtype, bf16 under f32 activations, or int8 with its f32
scales) and the kernel built for that storage reads it as such: no wrapper
widens a cache or a weight before a launch.

Autograd cannot see a launch through ``ctypes``, so every kernel that
training crosses (``flash_attention``, ``fused_mlp``, ``fused_mlp_routed``,
``moe_gmm``) runs inside ``KernelOp``, a ``torch.autograd.Function`` whose
forward is the kernel and whose backward replays the plain version: the
counterpart of the JAX package's custom VJPs, which replay its jnp oracles
(there are no backward kernels to port). ``decode_attention`` and
``paged_decode_attention`` serve only.

Accounting (``launch/hloprof.py``, ``repro_torch.analysis``): every wrapper
reports one ``KernelCall`` to each active ``recording()`` (its arguments,
``kernel_cost`` and its operand and output bytes), whether it launches
the kernel or runs the plain version, and suspends the recorders while it
runs, so an op recorder never counts the plain version's operations or a
wrapper's own bookkeeping: a CPU count and a card count of the same call
agree. ``launch_geometry`` states in Python how each C launcher sizes its
launches; ``c_geometry`` asks the launcher itself, through its
``*_geometry`` C entry (the launch's own host code, stopped before the
launch).
"""
from __future__ import annotations

import ctypes
import functools
import inspect
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref, fused_mlp_ref,
                                     fused_mlp_routed_ref, moe_gmm_ref,
                                     paged_decode_attention_ref)

BACKENDS = ("auto", "cuda", "ref")
KERNELS = ("flash_attention", "fused_mlp", "fused_mlp_routed",
           "decode_attention", "moe_gmm", "paged_decode_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # rt::DT_F32 / rt::DT_BF16
DT_I8 = 2                                         # rt::DT_I8 (storage only)
_launches = {name: 0 for name in KERNELS}


class KernelOp(torch.autograd.Function):
    """``KernelOp.apply(kernel, plain, *args)``: the forward returns
    ``kernel(*args)``; the backward replays ``plain(*args)`` under
    ``enable_grad`` and returns the gradients of the floating-point tensor
    arguments that ``ctx.needs_input_grad`` asks for (frozen weights ask
    for none), and ``None`` for the rest (integer and bool tensors, None)."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        args = ctx.saved_tensors
        want = [i for i, a in enumerate(args)
                if a is not None and a.is_floating_point()
                and ctx.needs_input_grad[2 + i]]
        grads = [None] * len(args)
        if want:
            with torch.enable_grad():
                ins = [a.detach().requires_grad_(True) if i in want else a
                       for i, a in enumerate(args)]
                out = ctx.plain(*ins)
                for i, g in zip(want, torch.autograd.grad(
                        out, [ins[i] for i in want], grad)):
                    grads[i] = g
        return (None, None, *grads)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


class captured_launches:
    """``with captured_launches() as per_replay:`` around a CUDA-graph
    capture: the wrappers' launches inside are recorded, not counted (a
    capture launches nothing); on exit ``per_replay`` holds each kernel's
    launches per replay of the graph, for ``count_replay``."""

    def __enter__(self) -> dict:
        self._before, self._per_replay = dict(_launches), {}
        return self._per_replay

    def __exit__(self, *exc) -> None:
        for name, n in self._before.items():
            self._per_replay[name] = _launches[name] - n
            _launches[name] = n


def count_replay(per_replay: dict) -> None:
    """One replay of a captured graph launched ``per_replay``'s kernels
    (``captured_launches``): each count goes up by them."""
    for name, n in per_replay.items():
        _launches[name] += n


def use_kernel(backend, t: torch.Tensor) -> bool:
    """Resolve ``backend`` for tensor ``t``: True = launch the CUDA kernel."""
    if backend in (None, "auto"):
        return t.is_cuda
    if backend == "ref":
        return False
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors")
        return True
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _dtype_code(*ts) -> int:
    dt = ts[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in ts):
        raise TypeError(f"kernels take matching float32 or bfloat16 tensors, "
                        f"got {[t.dtype for t in ts]}")
    return _DTYPES[dt]


def storage_code(act_dtype, tensors, scales, what: str) -> int:
    """rt dtype code of ``tensors`` (K and V, or an MLP's weights), all
    of one storage dtype, under activations of ``act_dtype``: that dtype,
    bf16 under f32, or int8 with every one of ``scales`` given. Raises
    TypeError / ValueError for anything else."""
    dt = tensors[0].dtype
    if dt == act_dtype and dt in _DTYPES and all(
            t.dtype == dt for t in tensors) and all(
            sc is None for sc in scales):         # the float path, first
        return _DTYPES[dt]
    if any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} must share one storage dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if dt == torch.int8:
        if any(sc is None for sc in scales):
            raise ValueError(f"int8 {what} need their f32 scales")
        return DT_I8
    if any(sc is not None for sc in scales):
        raise ValueError(f"scales given for {dt} {what}")
    if act_dtype in _DTYPES and (dt == act_dtype or (
            dt == torch.bfloat16 and act_dtype == torch.float32)):
        return _DTYPES[dt]
    raise TypeError(f"{what} stored as {dt} under {act_dtype} activations: "
                    f"the kernels take the activation dtype, bf16 under "
                    f"f32, or int8 with scales")


def _scale_ptr(sc, shape, device):
    """An f32 scale operand as a contiguous tensor of ``shape`` on
    ``device`` -> (keep-alive, pointer); (None, None) for None."""
    if sc is None:
        return None, None
    if tuple(sc.shape) != tuple(shape):
        raise ValueError(f"scale {tuple(sc.shape)}, want {tuple(shape)}")
    sc = sc.to(device=device, dtype=torch.float32).contiguous()
    return sc, sc.data_ptr()


def _counts_vec(count, batch: int, limit: int, device) -> torch.Tensor:
    """None | scalar | (B,) -> contiguous (B,) int32 clipped to [0, limit]
    (one small kernel: a fill, or a clamp of an int32 count)."""
    if count is None:
        return torch.full((batch,), limit, dtype=torch.int32, device=device)
    c = torch.as_tensor(count, device=device).reshape(-1)
    if c.dtype != torch.int32:
        c = c.to(torch.int64)
    return c.expand(batch).clamp(0, limit).to(torch.int32).contiguous()


def _mask_ptr(mask, shape, device):
    """Optional bool mask broadcast to ``shape`` -> (keep-alive, pointer)."""
    if mask is None:
        return None, None
    m = mask if (mask.dtype == torch.bool and mask.device == device
                 and tuple(mask.shape) == shape and mask.is_contiguous()) \
        else mask.to(device=device, dtype=torch.bool).expand(shape) \
        .contiguous()
    return m, m.data_ptr()


def _as_tensor(v):
    """A Python count becomes a tensor: ``KernelOp`` saves its tensor
    arguments for the backward replay."""
    return v if v is None or torch.is_tensor(v) else torch.as_tensor(v)


def _check(rc: int, name: str) -> None:
    if rc >= 200000:     # csrc/hopper.cuh hp::ERR_NO_ENCODER
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled not found")
    if rc >= 100000:     # hp::ERR_ENCODE + CUresult
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a "
                           f"tensor map, CUresult {rc - 100000}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    if _geometry[0] is None:
        _launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------ recorders and geometry mode -------------------------

GEOM_MAX = 4                # launches one C call makes, at most
_geometry = [None]          # a list while ``geometry_only`` is active
_recorders: list = []       # the active ``recording`` contexts
_suspended = [0]            # > 0 inside a reporting wrapper


def _launch(lib, entry: str, *args) -> int:
    """Calls the C entry ``<entry>_launch(*args)``; under ``geometry_only``
    calls ``<entry>_geometry`` with the same arguments but the stream,
    which runs the launcher's host code up to its launches and reports
    their geometry instead of launching, and keeps what it reports."""
    if _geometry[0] is None:
        return getattr(lib, entry + "_launch")(*args)
    out = (ctypes.c_int * (1 + 5 * GEOM_MAX))()
    rc = getattr(lib, entry + "_geometry")(*args[:-1], out)
    _geometry[0] += [((out[1 + 5 * i], out[2 + 5 * i], out[3 + 5 * i]),
                      out[4 + 5 * i], out[5 + 5 * i]) for i in range(out[0])]
    return rc


class geometry_only:
    """``with geometry_only() as launches:`` around CUDA wrapper calls:
    each C launcher reports, and nothing launches; ``launches`` gets one
    ((grid x, y, z), block threads, dynamic shared bytes) per launch the
    calls would make, in order, and no launch count moves."""

    def __enter__(self) -> list:
        if _geometry[0] is not None:
            raise RuntimeError("geometry_only does not nest")
        _geometry[0] = []
        return _geometry[0]

    def __exit__(self, *exc) -> None:
        _geometry[0] = None


class KernelCall(NamedTuple):
    """One wrapper call as a ``recording`` sees it: its arguments by name
    (defaults applied), ``kernel_cost`` (None when the recording asked for
    no cost) and the bytes of its tensor operands and of its output."""
    name: str
    args: dict
    cost: object
    in_bytes: int
    out_bytes: int


def call_signature(call: KernelCall) -> tuple:
    """A recorded call's launch signature, hashable: its kernel, each
    tensor operand's shape and dtype, and its other arguments by
    ``repr``. Calls with one signature launch one form of the kernel."""
    return (call.name,) + tuple(
        (k, (tuple(v.shape), v.dtype) if torch.is_tensor(v) else repr(v))
        for k, v in call.args.items())


class recording:
    """``with recording() as calls:``: every wrapper call made inside
    appends its ``KernelCall`` to ``calls`` (``into``, when given)
    (``cost=False``: without ``kernel_cost``, which reads the call's masks
    and counts)."""

    def __init__(self, cost: bool = True, into=None):
        self.cost = cost
        self.calls = [] if into is None else into

    def __enter__(self) -> list:
        _recorders.append(self)
        return self.calls

    def __exit__(self, *exc) -> None:
        _recorders.remove(self)


class _suspend:
    def __enter__(self):
        _suspended[0] += 1

    def __exit__(self, *exc):
        _suspended[0] -= 1


def recording_suspended() -> bool:
    """True inside a reporting wrapper: an op recorder (``launch/hloprof``)
    skips what runs there (the plain version on the CPU, the wrapper's own
    allocations and conversions on the card), which the call's
    ``KernelCall`` stands for."""
    return _suspended[0] > 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _reported(fn):
    """Decorator of the public wrappers: with a ``recording`` active, the
    call runs with the recorders suspended and reports one ``KernelCall``
    (the kernel and the plain version alike)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not _recorders or _suspended[0]:
            return fn(*args, **kw)
        with _suspend():
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            a = dict(bound.arguments)
            out = fn(*args, **kw)
            cost = kernel_cost(fn.__name__, **a) \
                if any(r.cost for r in _recorders) else None
            call = KernelCall(fn.__name__, a, cost,
                              sum(_nbytes(v) for v in a.values()),
                              _nbytes(out))
            for r in list(_recorders):
                r.calls.append(call if r.cost else call._replace(cost=None))
        return out

    _WRAPPERS[fn.__name__] = wrapper
    return wrapper


_WRAPPERS: dict = {}        # name -> the reporting wrapper


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (TMA boxes and
    16-byte copies); a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_attention_shapes(name, q, k, v, head_dims) -> None:
    """Raises ValueError unless q (B,Sq,H,Dh) and k, v (B,S,K,Dh) (a
    decode pool: (N,ps,K,Dh)) are shapes the kernel ``name`` takes: Dh in
    ``head_dims``, K dividing H, k and v alike and of q's Dh."""
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or q.shape[-1] not in head_dims or k.shape[-1] != q.shape[-1]
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]):
        raise ValueError(f"{name} kernel: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")


# ----------------------------- flash attention -------------------------------
#
# Replaces kernels/flash_attention.py::flash_attention (TPU). Bound on the
# H100 at the serving shapes: FLOPs (tensor-core rate). bf16 at Dh 64 / 128
# / 256 runs on the tensor cores (wgmma, K/V tiles through a TMA ring); f32,
# and the toy widths 16 / 32, on the CUDA cores (csrc/flash_attention.cu).

@_reported
def flash_attention(q, k, v, kv_valid=None, kv_count=None, *, causal=True,
                    window=0, backend=None):
    """q: (B,Sq,H,Dh); k, v: (B,Sk,K,Dh); kv_valid: (B,Sk) or (Sk,) bool;
    kv_count: None, scalar or (B,) count of real leading rows. Returns
    (B,Sq,H,Dh) in q's dtype; query rows with no attendable key are 0."""
    def plain(q, k, v, kv_valid, kv_count):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_valid=kv_valid, kv_count=kv_count)

    if not use_kernel(backend, q):
        return plain(q, k, v, kv_valid, kv_count)
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    check_attention_shapes("flash_attention", q, k, v,
                           (16, 32, 64, 128, 256))
    dt = _dtype_code(q, k, v)

    def kernel(q, k, v, kv_valid, kv_count):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        out = torch.empty_like(q)
        valid, valid_ptr = _mask_ptr(kv_valid, (B, Sk), q.device)
        cnt = None if kv_count is None else _counts_vec(
            kv_count, B, max(Sq, Sk), q.device)
        lib = build.load("flash_attention")
        with torch.cuda.device(q.device):
            rc = _launch(lib, "flash_attention",
                dt, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), valid_ptr, _ptr(cnt), B, Sq, Sk, H, K,
                int(bool(causal)), int(window or 0), float(Dh ** -0.5),
                _stream(q))
        _check(rc, "flash_attention")
        return out

    return KernelOp.apply(kernel, plain, q, k, v, _as_tensor(kv_valid),
                          _as_tensor(kv_count))


# -------------------------------- fused MLP ----------------------------------
#
# Replaces kernels/fused_mlp.py::fused_mlp (TPU). Bound on the H100: FLOPs
# (tensor-core rate) at a prefill, the weights' bytes at a 16-row chunk. Two
# phases without atomics (csrc/fused_mlp.cu), run by one of two bodies that
# ``mlp_plan`` picks from dtype and shape: bf16 at widths that are
# multiples of 64 on the tensor cores (wgmma, a TMA weight ring, hidden in a
# bf16 scratch), everything else on the CUDA cores (hidden in f32).

MLP_FILL_BLOCKS = 100   # down-phase blocks a split aims for (132 SMs)


class MlpPlan(NamedTuple):
    """How ``csrc/fused_mlp.cu`` runs an MLP call (any mode): ``body``
    "wgmma" (tensor cores) or "cuda_core"; for "wgmma", ``rows`` per block
    (64 or 128) and ``split``, the parts of the down phase's F reduction."""
    body: str
    rows: int = 0
    split: int = 0


def mlp_plan(dtype, B: int, T: int, D: int, F: int,
             weights=None) -> MlpPlan:
    """The body, tile rows and split of an MLP call over B groups of T
    buffer rows (T = Kb in routed mode; ``moe_gmm``: B·E groups of C
    slots), from dtype and shape only — never from the counts, the
    indices or the data, so a row's bits do not depend on what else is
    in the call's tiles (budget 1.0 == teacher,
    staggered == solo). bf16 with D and F multiples of 64 runs on the
    tensor cores: 64-row tiles for T <= 64 (a bandwidth-bound call), else
    128; the down phase's F reduction is split when its B * row tiles *
    D/128 column tiles are fewer than MLP_FILL_BLOCKS. f32 stays on the
    CUDA cores on purpose (TF32 would break the f32 1e-4 tolerance), as do
    widths that are not multiples of 64 (the toy configs). ``weights``:
    the weights' storage dtype (default ``dtype``): int8 weights under bf16
    take the tensor-core body too (its int8 form: int8 tiles through the
    TMA ring, widened to bf16 in shared memory), bf16 weights under f32 x
    the CUDA-core body."""
    if dtype != torch.bfloat16 or D % 64 or F % 64 or (
            weights not in (None, dtype, torch.int8)):
        return MlpPlan("cuda_core")
    rows = 64 if T <= 64 else 128
    tiles = B * -(-T // rows) * -(-D // 128)
    split = min(F // 64, max(1, -(-MLP_FILL_BLOCKS // max(tiles, 1))))
    return MlpPlan("wgmma", rows, split)


def _mlp_weights(x3, wi, wo, wg, scales=(None, None, None)):
    """The weights' storage code (``storage_code``); raises unless they fit
    x's width and are stored as the kernels take them. ``scales``: (wi_s,
    wg_s, wo_s)."""
    D, F = x3.shape[-1], wi.shape[1]
    if wi.shape != (D, F) or wo.shape != (F, D) or (
            wg is not None and wg.shape != (D, F)):
        raise ValueError("fused_mlp kernel: weight shapes do not match x")
    _dtype_code(x3)
    ws = [wi, wo] + ([wg] if wg is not None else [])
    sc = [scales[0], scales[2]] + ([scales[1]] if wg is not None else [])
    return storage_code(x3.dtype, ws, sc, "MLP weights")


def _act_code(act, gated: bool) -> int:
    """rt act codes: 0 = silu, 1 = tanh-GELU (the gate's, when gated)."""
    if gated:
        return 0 if act == "swiglu" else 1
    return 1 if act == "gelu" else 0


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_mlp(name, x, idx, wi, wo, wg, tw, cnt, out, act, G, T_, S_,
                w_code=None, scales=(None, None, None)):
    """One dense (idx None; x (G, T_, D)) or routed (x (G, S_, D), idx
    (G, T_) int32) MLP call of csrc/fused_mlp.cu into ``out``, by the body
    ``mlp_plan`` picks; tw (G, T_) f32 or None, cnt (G,) int32; w_code the
    weights' storage code (default x's), ``scales`` (wi_s, wg_s, wo_s) of
    int8 weights. Allocates the hidden scratch (and the
    tensor-core body's partials of the down phase, unless it stores the
    output itself: one part, dense mode)."""
    D, F = x.shape[-1], wi.shape[1]
    plan = mlp_plan(x.dtype, G, T_, D, F, weights=wi.dtype)
    act_code = _act_code(act, wg is not None)
    lib = build.load("fused_mlp")
    dt = _DTYPES[x.dtype]
    wdt = dt if w_code is None else w_code
    keep = [(None, None)] * 3 if all(sc is None for sc in scales) else [
        _scale_ptr(sc, shape, x.device)
        for sc, shape in zip(scales, ((F,), (F,), (D,)))]
    if plan.body == "wgmma":
        x, wi, wo = _aligned(x), _aligned(wi), _aligned(wo)
        wg = _aligned(wg) if wg is not None else None
        hbuf = torch.empty((G, T_, F), dtype=torch.bfloat16, device=x.device)
        part = torch.empty((plan.split, G, T_, D), dtype=torch.float32,
                           device=x.device) \
            if plan.split > 1 or idx is not None else None
        with torch.cuda.device(x.device):
            rc = _launch(lib, "fused_mlp_tc",
                wdt, x.data_ptr(), _ptr(idx), wi.data_ptr(), _ptr(wg),
                wo.data_ptr(), *(p for _, p in keep), _ptr(tw),
                cnt.data_ptr(), hbuf.data_ptr(), _ptr(part), out.data_ptr(),
                G, T_, S_, D, F, act_code, plan.rows // 64, plan.split,
                _stream(x))
    else:
        hbuf = torch.empty((G, T_, F), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            if idx is None:
                rc = _launch(lib, "fused_mlp",
                    dt, wdt, x.data_ptr(), wi.data_ptr(), _ptr(wg),
                    wo.data_ptr(), *(p for _, p in keep), _ptr(tw),
                    cnt.data_ptr(), hbuf.data_ptr(), out.data_ptr(), G, T_,
                    D, F, act_code, _stream(x))
            else:
                rc = _launch(lib, "fused_mlp_routed",
                    dt, wdt, x.data_ptr(), idx.data_ptr(), wi.data_ptr(),
                    _ptr(wg), wo.data_ptr(), *(p for _, p in keep),
                    _ptr(tw), cnt.data_ptr(), hbuf.data_ptr(),
                    out.data_ptr(), G, S_, T_, D, F, act_code, _stream(x))
    _check(rc, name)


@_reported
def fused_mlp(x, wi, wo, wg=None, token_weights=None, valid_count=None,
              wi_scale=None, wo_scale=None, wg_scale=None, *, act="swiglu",
              backend=None):
    """x: (T, D) or (B, T, D); wi/wg: (D, F); wo: (F, D), stored as x, as
    bf16 under f32 x, or int8 with f32 scales wi_scale/wg_scale (F,) and
    wo_scale (D,); token_weights: (T,) or (B, T); valid_count: None,
    scalar or (B,) count of real leading rows (rows past it are 0).
    Returns x-shaped output in x's dtype."""
    # the scales ride in the closures: they never ask for a gradient
    def plain(x, wi, wo, wg, tw, cnt):
        return fused_mlp_ref(x, wi, wo, wg, tw, act=act, valid_count=cnt,
                             wi_scale=wi_scale, wo_scale=wo_scale,
                             wg_scale=wg_scale)

    if not use_kernel(backend, x):
        return plain(x, wi, wo, wg, token_weights, valid_count)
    squeeze = x.dim() == 2
    B, T, D = (x[None] if squeeze else x).shape
    w_code = _mlp_weights(x, wi, wo, wg, (wi_scale, wg_scale, wo_scale))

    def kernel(x, wi, wo, wg, tw, cnt):
        x3 = (x[None] if squeeze else x).contiguous()
        wi, wo = wi.contiguous(), wo.contiguous()
        wg = wg.contiguous() if wg is not None else None
        if tw is not None:
            tw = tw.to(device=x.device, dtype=torch.float32)
            tw = tw.reshape(-1, T).expand(B, T).contiguous()
        cnt = _counts_vec(cnt, B, T, x.device)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        _launch_mlp("fused_mlp", x3, None, wi, wo, wg, tw, cnt, out, act, B,
                    T, T, w_code, (wi_scale, wg_scale, wo_scale))
        return out

    return KernelOp.apply(kernel, plain, x, wi, wo, wg, token_weights,
                          _as_tensor(valid_count))


# ---------------------------- routed fused MLP -------------------------------
#
# Replaces kernels/fused_mlp.py::fused_mlp_routed (TPU). The same two phases
# and bodies as fused_mlp (csrc/fused_mlp.cu, routed mode): the up phase
# gathers x rows through idx (cp.async on the tensor-core body) and the
# stores scatter the weighted rows back, into an output zero-filled first.
# The weights are stored as fused_mlp's are: int8 ones with their scales
# come from a train-mode serving engine's admissions, and on the
# tensor-core body their int8 B tiles share each stage with the gathered
# rows. The TPU kernel's resident (S, D) output slab and its VMEM limit
# have no counterpart here. Bound on the H100 at a training step and at a
# 512-token admission: FLOPs (tensor-core rate), as for fused_mlp.

@_reported
def fused_mlp_routed(x, idx, wi, wo, wg=None, token_weights=None,
                     valid_count=None, wi_scale=None, wo_scale=None,
                     wg_scale=None, *, act="swiglu", backend=None):
    """x: (B, S, D) full residual stream; idx: (B, Kb) RoutingPlan gather
    indices (no duplicates in a row); token_weights: (B, Kb); valid_count:
    None, scalar or (B,) selected count; wi/wg: (D, F), wo: (F, D), stored
    as x, as bf16 under f32 x, or int8 with f32 scales wi_scale/wg_scale
    (F,) and wo_scale (D,). Returns the (B, S, D) delta in x's dtype: row
    idx[b, i] with i < count[b] gets token_weights[b, i] *
    MLP(x[b, idx[b, i]]), every other row is exactly zero."""
    # the scales ride in the closures: they never ask for a gradient
    def plain(x, idx, wi, wo, wg, tw, cnt):
        return fused_mlp_routed_ref(x, idx, wi, wo, wg, tw, act=act,
                                    valid_count=cnt, wi_scale=wi_scale,
                                    wo_scale=wo_scale, wg_scale=wg_scale)

    if not use_kernel(backend, x):
        return plain(x, idx, wi, wo, wg, token_weights, valid_count)
    B, S, D = x.shape
    Kb = idx.shape[-1]
    if idx.shape != (B, Kb) or Kb > S:
        raise ValueError(f"fused_mlp_routed kernel: idx {tuple(idx.shape)} "
                         f"does not index x {tuple(x.shape)}")
    w_code = _mlp_weights(x, wi, wo, wg, (wi_scale, wg_scale, wo_scale))

    def kernel(x, idx, wi, wo, wg, tw, cnt):
        x = x.contiguous()
        ix = idx.to(device=x.device, dtype=torch.int32).contiguous()
        wi, wo = wi.contiguous(), wo.contiguous()
        wg = wg.contiguous() if wg is not None else None
        if tw is not None:
            tw = tw.to(device=x.device, dtype=torch.float32)
            tw = tw.expand(B, Kb).contiguous()
        cnt = _counts_vec(cnt, B, Kb, x.device)
        out = torch.empty_like(x)
        _launch_mlp("fused_mlp_routed", x, ix, wi, wo, wg, tw, cnt, out, act,
                    B, Kb, S, w_code, (wi_scale, wg_scale, wo_scale))
        return out

    return KernelOp.apply(kernel, plain, x, idx, wi, wo, wg, token_weights,
                          _as_tensor(valid_count))


# --------------------------------- MoE GMM -----------------------------------
#
# Replaces kernels/moe_gmm.py::moe_gmm (TPU). The grouped-expert mode of
# csrc/fused_mlp.cu: its two phases over one group per (b, e), and tiles at
# or past a group's count do no work and are written as zeros. The bodies
# are fused_mlp's, picked by ``mlp_plan`` over the B * E groups of C slots
# (shape only, never the counts, so a slot's bits do not depend on what
# else was dispatched: budget 1.0 == teacher, staggered == solo; its
# 128-row tiles past C = 64 beat 64-row tiles on the H100 at the heaviest
# call of each expert path, PERF.md): bf16 at widths that are multiples of
# 64 on the tensor cores, where expert e's weight tiles are TMA boxes at
# coordinates moved by e in one 2-D map over each matrix's storage
# (``gmm_map``); everything else on the CUDA cores, through the expert and
# row strides. Either way the moefied views of a dense MLP (core/moefy.py)
# and native expert stacks both go in without a copy. Bound on the H100:
# FLOPs at the moefied Qwen2-7B calls (hundreds of rows per expert); bytes
# at the native Qwen1.5-MoE ones (60 experts' ~1 GB of weights), nearly
# balanced with FLOPs at its heaviest call (~290 rows per expert).

def _expert_strides(w, shape, name):
    """(expert stride, row stride) in elements of an (E, rows, cols)
    weight whose last dimension is contiguous."""
    if tuple(w.shape) != shape or w.stride(-1) != 1:
        raise ValueError(f"moe_gmm kernel: {name} {tuple(w.shape)} strides "
                         f"{w.stride()}, want {shape} with a contiguous "
                         f"last dimension")
    return w.stride(0), w.stride(1)


def gmm_map(w, shape, name) -> tuple:
    """How the tensor-core body reads an (E, rows, cols) expert weight in
    place: (map columns, map rows, expert column step, expert row step) of
    one 2-D map whose columns are the weight's row stride, expert e's tile
    at (e * column step, e * row step). Two layouts have one: experts side
    by side in each row (the moefied views of a dense (D, E*Fe) wi or wg:
    column step Fe) and experts stacked by rows (native (E, D, Fe) stacks
    and every wo: row step rows). Raises ValueError for any other layout,
    a row stride that is not a multiple of 16 bytes or a start that is not
    16-byte aligned (TMA's rules)."""
    es, rs = _expert_strides(w, shape, name)
    E, rows, cols = shape
    if rs * w.element_size() % 16 == 0 and w.data_ptr() % 16 == 0 \
            and cols <= rs:
        if E == 1 or (E - 1) * es + cols <= rs:
            return rs, rows, es if E > 1 else 0, 0
        if es % rs == 0:
            return rs, (E - 1) * (es // rs) + rows, 0, es // rs
    raise ValueError(f"moe_gmm kernel: {name} {tuple(w.shape)} strides "
                     f"{w.stride()} at byte {w.data_ptr() % 16} of 16: "
                     f"neither experts side by side in each row nor "
                     f"stacked by rows, 16-byte aligned")


@_reported
def moe_gmm(x, wi, wo, wg=None, weights=None, group_counts=None,
            wi_scale=None, wo_scale=None, wg_scale=None, *, act="swiglu",
            backend=None):
    """x: (E, C, D) or (B, E, C, D) dispatched tokens; wi/wg: (E, D, Fe)
    and wo: (E, Fe, D), any strides with a contiguous last dimension (wg
    with wi's; on the tensor-core body one of the two ``gmm_map`` layouts),
    stored as x, as bf16 under f32 x, or int8 with f32 per-(expert,
    channel) scales wi_scale/wg_scale (E, Fe) and wo_scale (E, D);
    weights: (E, C) / (B, E, C); group_counts: (E,) / (B, E) count of real
    leading slots per group (None = C). Returns x's shape and dtype; slots
    at or past their group's count are exactly zero."""
    # the scales ride in the closures: they never ask for a gradient
    def plain(x, wi, wo, wg, w, cnt):
        return moe_gmm_ref(x, wi, wo, wg, w, act=act, group_counts=cnt,
                           wi_scale=wi_scale, wo_scale=wo_scale,
                           wg_scale=wg_scale)

    if not use_kernel(backend, x):
        return plain(x, wi, wo, wg, weights, group_counts)
    squeeze = x.dim() == 3
    B, E, C, D = (x[None] if squeeze else x).shape
    Fe = wi.shape[-1]
    dt = _dtype_code(x)
    ws = [wi, wo] + ([wg] if wg is not None else [])
    w_code = storage_code(x.dtype, ws, [wi_scale, wo_scale] + (
        [wg_scale] if wg is not None else []), "expert weights")

    def kernel(x, wi, wo, wg, w, cnt):
        plan = mlp_plan(x.dtype, B * E, C, D, Fe, weights=wi.dtype)
        strides = [*_expert_strides(wi, (E, D, Fe), "wi"),
                   *_expert_strides(wo, (E, Fe, D), "wo")]
        if wg is not None and _expert_strides(wg, (E, D, Fe), "wg") != \
                tuple(strides[:2]):
            raise ValueError(f"moe_gmm kernel: wg strides {wg.stride()} "
                             f"differ from wi's {wi.stride()}")
        if plan.body == "wgmma":
            maps = [*gmm_map(wi, (E, D, Fe), "wi"),
                    *gmm_map(wo, (E, Fe, D), "wo")]
            if wg is not None:      # wi's strides (checked above), its start
                gmm_map(wg, (E, D, Fe), "wg")
        x4 = (x[None] if squeeze else x).contiguous()
        if w is not None:
            w = w.to(device=x.device, dtype=torch.float32)
            w = w.reshape(-1, E, C).expand(B, E, C).contiguous()
        if cnt is None:
            cnt = torch.full((B, E), C, dtype=torch.int32, device=x.device)
        else:
            cnt = torch.as_tensor(cnt, device=x.device).to(torch.int32)
            cnt = cnt.reshape(-1, E).expand(B, E).clamp(0, C).contiguous()
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        act_code = _act_code(act, wg is not None)
        lib = build.load("fused_mlp")
        keep = [_scale_ptr(sc, shape, x.device) for sc, shape in
                zip((wi_scale, wg_scale, wo_scale),
                    ((E, Fe), (E, Fe), (E, D)))]
        if plan.body == "wgmma":
            x4 = _aligned(x4)
            hbuf = torch.empty((B, E, C, Fe), dtype=torch.bfloat16,
                               device=x.device)
            # the down phase stores the output itself unless F is split
            part = torch.empty((plan.split, B, E, C, D), dtype=torch.float32,
                               device=x.device) if plan.split > 1 else None
            with torch.cuda.device(x.device):
                rc = _launch(lib, "moe_gmm_tc",
                    w_code, x4.data_ptr(), wi.data_ptr(), _ptr(wg),
                    wo.data_ptr(), *(p for _, p in keep), _ptr(w),
                    cnt.data_ptr(), hbuf.data_ptr(), _ptr(part),
                    out.data_ptr(), B, E, C, D, Fe, act_code,
                    plan.rows // 64, plan.split, *maps, _stream(x))
        else:
            hbuf = torch.empty((B, E, C, Fe), dtype=torch.float32,
                               device=x.device)
            with torch.cuda.device(x.device):
                rc = _launch(lib, "moe_gmm",
                    dt, w_code, x4.data_ptr(), wi.data_ptr(), _ptr(wg),
                    wo.data_ptr(), *(p for _, p in keep), *strides, _ptr(w),
                    cnt.data_ptr(), hbuf.data_ptr(), out.data_ptr(), B, E, C,
                    D, Fe, act_code, _stream(x))
        _check(rc, "moe_gmm")
        return out

    return KernelOp.apply(kernel, plain, x, wi, wo, wg, weights,
                          _as_tensor(group_counts))


# ----------------------------- decode attention ------------------------------
#
# Replaces kernels/decode_attention.py::decode_attention (TPU). Bound on the
# H100: bytes (the attended K/V rows). csrc/decode_attention.cu: one block
# per (kv-head, slot, split) reads each attended row once for the GQA group
# and writes an f32 partial; a second launch merges the splits in order.
# One call, two launches, one count in ``launch_counts()``. A masked ring
# slot is skipped before its K/V row is read.

DECODE_CHUNK = 128   # keys a split block takes at once (csrc NK)


def decode_split_plan(n_keys: int, page_size: int = 1) -> tuple:
    """(keys per split, number of splits) of a decode call whose keys are
    [0, n_keys): ring L, or P * page_size for a paged table row. A split is
    whole pages, DECODE_CHUNK keys when the page size divides it. The plan
    depends on n_keys and the page size only, never on the batch, t or
    which slots are active, so a slot's output depends only on its keys."""
    if n_keys < 0 or page_size < 1:
        raise ValueError(f"decode_split_plan({n_keys}, {page_size})")
    per = max(1, DECODE_CHUNK // page_size) * page_size
    return per, max(1, -(-n_keys // per))


def decode_scratch(B: int, H: int, Dh: int, n_split: int, device):
    """The f32 scratch of one decode call, one flat allocation: each
    split's unnormalised output (B, H, n_split, Dh), then its (running max,
    row sum) (B, H, n_split, 2)."""
    return torch.empty(B * H * n_split * (Dh + 2), dtype=torch.float32,
                       device=device)


def _int32(x, shape, device):
    """``x`` as a contiguous int32 tensor of ``shape`` on ``device``; one
    that already is passes through without a copy (the serving loop's
    positions and tables do: it saves host time on every decode call)."""
    if (torch.is_tensor(x) and x.dtype == torch.int32 and x.device == device
            and tuple(x.shape) == shape and x.is_contiguous()):
        return x
    x = torch.as_tensor(x, device=device).to(torch.int32)
    return x.reshape(-1).expand(shape).contiguous() if len(shape) == 1 \
        else x.expand(shape).contiguous()


@_reported
def decode_attention(q, k, v, kv_pos, t, kv_valid=None, kscale=None,
                     vscale=None, *, window=0, backend=None):
    """q: (B,1,H,Dh); k, v: (B,L,K,Dh) ring caches, stored as q, as bf16
    under an f32 q, or int8 with f32 scales kscale/vscale (B,L,K); kv_pos:
    (B,L) absolute positions (-1 = empty); t: (B,) per-slot positions;
    kv_valid: (B,L) bool. Returns (B,1,H,Dh); slots with no attendable key
    get zeros."""
    if not use_kernel(backend, q):
        return decode_attention_ref(q, k, v, kv_pos, t, window=window,
                                    kv_valid=kv_valid, kscale=kscale,
                                    vscale=vscale)
    B, Sq, H, Dh = q.shape
    L, K = k.shape[1], k.shape[2]
    check_attention_shapes("decode_attention", q, k, v,
                           (32, 64, 128, 256))
    if Sq != 1 or k.shape[0] != B:
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)} is "
                         f"not one query row per slot of k {tuple(k.shape)}")
    dt = _dtype_code(q)
    kv_dt = storage_code(q.dtype, [k, v], [kscale, vscale], "K and V")
    ks, ks_ptr = _scale_ptr(kscale, (B, L, K), q.device)
    vs, vs_ptr = _scale_ptr(vscale, (B, L, K), q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    pos = _int32(kv_pos, (B, L), q.device)
    tv = _int32(t, (B,), q.device)
    valid, valid_ptr = _mask_ptr(kv_valid, (B, L), q.device)
    split, n_split = decode_split_plan(L)
    scratch = decode_scratch(B, H, Dh, n_split, q.device)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    with torch.cuda.device(q.device):
        rc = _launch(lib, "decode_attention",
            dt, kv_dt, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), ks_ptr,
            vs_ptr, out.data_ptr(), scratch.data_ptr(), pos.data_ptr(),
            tv.data_ptr(), valid_ptr, B, L, H, K, int(window or 0), split,
            n_split, float(Dh ** -0.5), _stream(q))
    _check(rc, "decode_attention")
    return out


# -------------------------- paged decode attention ---------------------------
#
# Replaces kernels/paged_decode_attention.py::paged_decode_attention (TPU).
# The paged mode of csrc/decode_attention.cu: the ring kernel's body with
# the key addressed through the page table and masked by its implicit
# position and pvalid; splits are whole pages, and keys past t are never
# visited. It serves paged decode and each paged prefill chunk (the chunk's
# C queries as C rows of one table row). Bound on the H100: bytes (the
# attended K/V rows).

@_reported
def paged_decode_attention(q, kp, vp, table, t, pvalid, kscale=None,
                           vscale=None, *, backend=None):
    """q: (B,1,H,Dh); kp, vp: (N, ps, K, Dh) page pool, stored as q, as
    bf16 under an f32 q, or int8 with f32 scale pools kscale/vscale (N, ps,
    K); table: (B, P) page-table rows (-1 = unused); t: (B,) per-slot
    positions; pvalid: (N, ps) bool. Returns (B,1,H,Dh); slots with no
    attendable key get zeros."""
    if not use_kernel(backend, q):
        return paged_decode_attention_ref(q, kp, vp, table, t, pvalid,
                                          kscale=kscale, vscale=vscale)
    B, Sq, H, Dh = q.shape
    N, ps, K = kp.shape[0], kp.shape[1], kp.shape[2]
    P = table.shape[-1]
    check_attention_shapes("paged_decode_attention", q, kp, vp, (32, 64, 128))
    if Sq != 1 or table.shape != (B, P) or pvalid.shape != (N, ps):
        raise ValueError(f"paged_decode_attention kernel: unsupported shapes "
                         f"q {tuple(q.shape)}, kp {tuple(kp.shape)}, table "
                         f"{tuple(table.shape)}, pvalid "
                         f"{tuple(pvalid.shape)}")
    dt = _dtype_code(q)
    kv_dt = storage_code(q.dtype, [kp, vp], [kscale, vscale], "K and V")
    ks, ks_ptr = _scale_ptr(kscale, (N, ps, K), q.device)
    vs, vs_ptr = _scale_ptr(vscale, (N, ps, K), q.device)
    q, kp, vp = _aligned(q), _aligned(kp), _aligned(vp)
    tbl = _int32(table, (B, P), q.device)
    tv = _int32(t, (B,), q.device)
    pv, pv_ptr = _mask_ptr(pvalid, (N, ps), q.device)
    split, n_split = decode_split_plan(P * ps, ps)
    scratch = decode_scratch(B, H, Dh, n_split, q.device)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    with torch.cuda.device(q.device):
        rc = _launch(lib, "paged_decode_attention",
            dt, kv_dt, Dh, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            ks_ptr, vs_ptr, out.data_ptr(), scratch.data_ptr(),
            tbl.data_ptr(), tv.data_ptr(), pv_ptr, B, P, ps, H, K, split,
            n_split, float(Dh ** -0.5), _stream(q))
    _check(rc, "paged_decode_attention")
    return out


def page_offset(n_local_pages: int, mesh=None) -> int:
    """The first global page id of this rank's slice of the page pool: its
    replica times the ``n_local_pages`` it holds (0 off a mesh or on a
    data axis of 1). The pool's page axis splits over the data axes, and
    the serving engine hands a slot pages of its own replica's contiguous
    range only (``runtime/pagedkv.PagePool``)."""
    from repro_torch.runtime.mesh import active_mesh
    mesh = mesh if mesh is not None else active_mesh()
    return 0 if mesh is None else mesh.data_rank * int(n_local_pages)


def rebase_pages(ids: torch.Tensor, offset: int) -> torch.Tensor:
    """Global page ids as ids into the rank's slice of the pool: ``-1``
    (an unused table entry) stays ``-1``, never a valid id."""
    if not offset:
        return ids
    return torch.where(ids >= 0, ids - offset, torch.full_like(ids, -1))


def paged_decode_attention_sharded(q, kp, vp, table, t, pvalid, kscale=None,
                                   vscale=None, *, backend=None, mesh=None):
    """The per-rank paged decode of a (data, model) mesh: the counterpart
    of the JAX package's ``ops.paged_decode_attention_sharded``
    (``kernels/ops.py:385-437``), whose shard body this is. The rank holds
    its replica's slots (q: (B/D, 1, H/M, Dh)), its replica's pages and
    kv-heads of the pool (kp, vp: (N/D, ps, K/M, Dh); pvalid (N/D, ps);
    scale pools (N/D, ps, K/M)); ``table`` holds GLOBAL page ids, rebased
    here by the replica's page offset (``-1`` stays ``-1``), and the
    paged kernel runs on the local operands. Off a mesh it is
    ``paged_decode_attention``."""
    table = rebase_pages(table, page_offset(kp.shape[0], mesh))
    return paged_decode_attention(q, kp, vp, table, t, pvalid, kscale,
                                  vscale, backend=backend)


# ----------------------- cost and launch statements ---------------------------
#
# ``kernel_cost`` is the work a call must do on its data (the bound of every
# timed case in chip_smoke.py and the kernels' share of
# ``launch/hloprof.py``'s counts); ``launch_geometry`` is how the C
# launchers size the call's launches, stated in Python from the same plans
# the wrappers hand them (``mlp_plan``, ``decode_split_plan``, ``gmm_map``).


def _bind(name: str, args, kw) -> dict:
    bound = inspect.signature(_WRAPPERS[name]).bind(*args, **kw)
    bound.apply_defaults()
    return dict(bound.arguments)


def _kind(t) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _live_counts(count, batch: int, limit: int, device) -> torch.Tensor:
    """(B,) int64 count of real leading rows, clipped to [0, limit]."""
    if count is None:
        return torch.full((batch,), limit, dtype=torch.int64, device=device)
    c = torch.as_tensor(count, device=device).to(torch.int64).reshape(-1)
    return c.expand(batch).clamp(0, limit)


def attention_pairs(B, Sq, Sk, kv_valid=None, kv_count=None, causal=True,
                    window=0, device=None) -> torch.Tensor:
    """(B, Sq, Sk) bool: the (query, key) pairs a ``flash_attention`` call
    attends, by array index (causal, window, kv_valid, and kv_count bounding
    the query rows and the keys alike), as its plain version masks them."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    m = (ki <= qi) if causal else torch.ones(Sq, Sk, dtype=torch.bool,
                                             device=device)
    if window and window > 0:
        m = m & ((qi - ki) < window)
    m = m[None].expand(B, Sq, Sk)
    if kv_valid is not None:
        m = m & kv_valid.to(device=device, dtype=torch.bool).expand(B, Sk)[
            :, None, :]
    cnt = _live_counts(kv_count, B, max(Sq, Sk), device)[:, None, None]
    return m & (ki[None] < cnt) & (qi[None] < cnt)


def ring_attended(kv_pos, t, kv_valid=None, window=0) -> torch.Tensor:
    """(B, L) bool: the ring keys a ``decode_attention`` call attends:
    written, at or before the slot's t, inside the window, valid."""
    t = torch.as_tensor(t, device=kv_pos.device).reshape(-1, 1)
    att = (kv_pos >= 0) & (kv_pos <= t)
    if window:
        att = att & ((t - kv_pos) < window)
    if kv_valid is not None:
        att = att & kv_valid.to(device=kv_pos.device, dtype=torch.bool)
    return att


def paged_keys(table, t, pvalid):
    """(attended, visited, lane), each (R, P * ps): a ``paged_decode_attention``
    call's keys that are attended (table entry >= 0, position <= t, pvalid
    of its page lane) and visited (entry >= 0, position <= t: the kernel
    reads their pvalid lanes), and each key's pool lane (page * ps + lane).
    Leading batch dimensions of table (R, P), t (R,) and pvalid (N, ps)
    (several calls stacked) carry over."""
    ps, P = pvalid.shape[-1], table.shape[-1]
    j = torch.arange(P * ps, device=table.device)
    ent = table[..., j // ps].long()
    visited = (ent >= 0) & (j <= t[..., None])
    lane = ent.clamp(min=0) * ps + j % ps
    pv = pvalid.flatten(-2).gather(-1, lane.flatten(-2)).reshape(ent.shape)
    return visited & pv.bool(), visited, lane


def _weight_bytes(ws, scales) -> int:
    """Each weight once in its storage type, plus its f32 scales."""
    return sum(_nbytes(w) for w in ws if w is not None) + sum(
        4 * sc.numel() for sc in scales if sc is not None)


def kernel_cost(name: str, *args, **kw) -> tuple:
    """(flops, bytes, kind) of one call of the wrapper ``name`` on its
    arguments: the work its data needs, not the most its shapes allow.
    FLOPs count attended (query, key) pairs (4 * Dh each per q-head: the
    scores and P V) and live rows of the MLP modes (2 * D * F each per
    matrix); bytes count every input the kernel must read once and every
    output once: q rows inside the count and the K/V rows some query
    attends (each once for its GQA group, int8 at 1 byte plus its f32
    scale), the weights (the live experts' in ``moe_gmm``) with their
    scales, the live x rows, the whole output, and the masks, positions,
    tables and counts the kernel reads. ``kind`` ("bf16" or "f32", the
    activations' type) picks the peak rate of ``hloprof.bound_ms``."""
    a = _bind(name, args, kw)
    if name == "flash_attention":
        q, k = a["q"], a["k"]
        B, Sq, H, Dh = q.shape
        Sk, K = k.shape[1], k.shape[2]
        m = attention_pairs(B, Sq, Sk, a["kv_valid"], a["kv_count"],
                            a["causal"], a["window"], q.device)
        q_rows = int(_live_counts(a["kv_count"], B, max(Sq, Sk),
                                  q.device).clamp(max=Sq).sum())
        kv_rows = int(m.any(1).sum())
        nbytes = ((q_rows + B * Sq) * H * Dh + 2 * kv_rows * K * Dh) \
            * q.element_size() + (B * Sk if a["kv_valid"] is not None else 0) \
            + (4 * B if a["kv_count"] is not None else 0)
        return 4 * Dh * H * int(m.sum()), nbytes, _kind(q)
    if name in ("fused_mlp", "fused_mlp_routed", "moe_gmm"):
        x, wi, wo, wg = a["x"], a["wi"], a["wo"], a["wg"]
        scales = (a["wi_scale"], a["wg_scale"], a["wo_scale"])
        n_mats = 3 if wg is not None else 2
        esz = x.element_size()
        if name == "moe_gmm":
            x4 = x if x.dim() == 4 else x[None]
            B, E, C, D = x4.shape
            Fe = wi.shape[-1]
            cnt = _live_counts(a["group_counts"], B * E, C, x.device) \
                if a["group_counts"] is None else torch.as_tensor(
                    a["group_counts"], device=x.device).to(
                    torch.int64).reshape(-1, E).expand(B, E).clamp(0, C)
            cnt = cnt.reshape(B, E)
            rows = int(cnt.sum())
            live_e = int((cnt.sum(0) > 0).sum())
            per_e = _weight_bytes((wi, wo, wg), scales) / E
            nbytes = live_e * per_e + (rows * D + x4.numel()) * esz \
                + 4 * B * E + (4 * B * E * C if a["weights"] is not None
                               else 0)
            return 2 * rows * D * Fe * n_mats, int(nbytes), _kind(x)
        D, F = x.shape[-1], wi.shape[1]
        if name == "fused_mlp":
            x3 = x if x.dim() == 3 else x[None]
            B, T = x3.shape[:2]
            rows = int(_live_counts(a["valid_count"], B, T, x.device).sum())
            nbytes = (rows + B * T) * D * esz
        else:
            B, S = x.shape[:2]
            T = a["idx"].shape[-1]
            rows = int(_live_counts(a["valid_count"], B, T, x.device).sum())
            nbytes = (rows + B * S) * D * esz + 4 * B * T
        nbytes += _weight_bytes((wi, wo, wg), scales) + 4 * B + (
            4 * B * T if a["token_weights"] is not None else 0)
        return 2 * rows * D * F * n_mats, nbytes, _kind(x)
    q = a["q"]
    H, Dh = q.shape[2], q.shape[3]
    if name == "decode_attention":
        k, pos = a["k"], a["kv_pos"]
        B, L, K = k.shape[:3]
        keys = int(ring_attended(pos, a["t"], a["kv_valid"],
                                 a["window"]).sum())
        kv_rows, extra = keys, 4 * B * L + 4 * B + (
            B * L if a["kv_valid"] is not None else 0)
    elif name == "paged_decode_attention":
        k, table = a["kp"], a["table"]
        K = k.shape[2]
        att, visited, lane = paged_keys(table, a["t"], a["pvalid"])
        keys = int(att.sum())
        kv_rows = int(lane[att].unique().numel())
        extra = 4 * table.numel() + 4 * q.shape[0] + int(
            lane[visited].unique().numel())
    else:
        raise ValueError(f"kernel_cost: no kernel {name!r}")
    row = K * (Dh * k.element_size() + (4 if a["kscale"] is not None else 0))
    nbytes = 2 * _nbytes(q) + 2 * kv_rows * row + extra
    return 4 * Dh * H * keys, nbytes, _kind(q)


SMEM_LIMIT = 227 * 1024      # dynamic shared memory a block may have (H100)
_NT = 256                    # threads of the CUDA-core MLP, flash and decode
_GMAX, _GH = 8, 4            # decode: q-heads of a block, scored per thread


def _struct(fields) -> int:
    """sizeof a C struct of (bytes, alignment) members, in order."""
    off, align = 0, 1
    for size, al in fields:
        off = -(-off // al) * al + size
        align = max(align, al)
    return -(-off // align) * align


def _flash_smem(body: str, Dh: int) -> int:
    if body == "wgmma":   # csrc/flash_attention.cu tc::Smem<DH> + slack
        box = 64 * 64 * 2
        return _struct([(Dh // 64 * box, 2), (2 * Dh // 64 * box, 2),
                        (2 * Dh // 64 * box, 2), (16, 8), (40, 8)]) + 1024
    return 4 * (64 * (Dh + 1) + Dh * 65 + 64 * Dh + 64 * 65 + 2 * 64)


def _mlp_tc_smem(up: bool, wgs: int) -> int:
    """csrc/fused_mlp.cu tc::Smem<UP, WGS> + alignment slack."""
    S = 2 if up and wgs == 1 else 4
    box = 64 * 64 * 2
    return _struct([(S * wgs * box, 2), (S * (2 if up else 1) * 2 * box, 2),
                    (4 * wgs * 64, 4), (16 * S, 8)]) + 1024


def _decode_smem(q_dtype, kv_dtype, Dh: int) -> int:
    """csrc/decode_attention.cu: SmemMma<DH, Q8> (bf16 q) or Smem<TKV, DH>."""
    NK = DECODE_CHUNK
    if q_dtype == torch.bfloat16:
        base = _struct([(NK * (Dh + 8) * 2, 2), (NK * (Dh + 8) * 2, 2),
                        (2 * _NT // 32 * _GMAX * 4, 4), (_GMAX * 4, 4),
                        (NK * 8, 8)])
        if kv_dtype != torch.int8:
            return base
        return _struct([(base, 8), (NK * (Dh + 16), 16), (NK * (Dh + 16), 1),
                        (NK * 4, 4), (NK * 4, 4)])
    sz = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[kv_dtype]
    E = 16 // sz
    one_buf = 2 * NK * (Dh + E) * sz > 160 * 1024
    kv = (NK + 1 if one_buf else 2 * NK) * (Dh + E) * sz
    red = _NT // (Dh // 2) * _GMAX * Dh * 4
    return _struct([(NK * (Dh + E) * sz, sz),
                    ((1 if one_buf else NK) * (Dh + E) * sz, sz),
                    (4 * (4 if kv >= red else (red - kv) // 4), 4),
                    (_GMAX * Dh * 4, 16), (NK * _GMAX * 4, 16),
                    (_NT // 32 * _GH * 4, 4), (NK * 4, 4), (NK * 4, 4),
                    (NK * 8, 8)])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile(operand, dims, tile, grid):
    """A launch's tiles over one operand: (name, its (rows, cols), the tile
    (rows, cols), tiles along (rows, cols) that the grid indexes)."""
    return (operand, tuple(dims), tuple(tile), tuple(grid))


def _mlp_geometry(kernel, dtype, w_dtype, G, T_, D, F, routed, E=None):
    """Launches of one MLP-mode C call over G groups of T_ buffer rows."""
    plan = mlp_plan(dtype, G, T_, D, F, weights=w_dtype)
    if G == 0 or T_ == 0:
        return plan, [], []
    if plan.body == "wgmma":
        R = plan.rows
        wgs = R // 64
        threads = wgs * 128 + (4 if wgs == 2 else 1) * 32
        mt = _cdiv(T_, R)
        up = dict(kernel=f"mlp_tc<up, {wgs}>", grid=(G * mt * _cdiv(F, 128),
                                                     1, 1),
                  block=threads, smem=_mlp_tc_smem(True, wgs))
        down = dict(kernel=f"mlp_tc<down, {wgs}>",
                    grid=(G * mt * _cdiv(D, 128), 1, plan.split),
                    block=threads, smem=_mlp_tc_smem(False, wgs))
        launches = [up, down]
        if plan.split > 1 or routed:
            launches.append(dict(kernel="mlp_finalize", grid=(
                _cdiv(G * T_ * (D // 4), 256), 1, 1), block=256, smem=0))
        tiles = [_tile("hidden", (T_, F), (R, 128), (mt, _cdiv(F, 128))),
                 _tile("out", (T_, D), (R, 128), (mt, _cdiv(D, 128)))]
        return plan, launches, tiles
    mt = _cdiv(T_, 64)
    launches = [dict(kernel="mlp_up", grid=(_cdiv(F, 64), mt, G), block=_NT,
                     smem=0),
                dict(kernel="mlp_down", grid=(_cdiv(D, 64), mt, G),
                     block=_NT, smem=0)]
    tiles = [_tile("hidden", (T_, F), (64, 64), (mt, _cdiv(F, 64))),
             _tile("out", (T_, D), (64, 64), (mt, _cdiv(D, 64)))]
    return plan, launches, tiles


def launch_geometry(name: str, *args, **kw) -> dict:
    """How the C launcher of wrapper ``name`` runs this call, stated in
    Python from the plans the wrapper hands it: ``body`` ("wgmma",
    "mma_sync" or "cuda_core"), ``launches`` (each kernel's grid (x, y, z),
    block threads and dynamic shared bytes, in launch order: what its
    ``*_geometry`` C entry reports, ``c_geometry``), ``tiles`` (per operand
    the tile and the tiles the grid indexes, for the in-bounds check) and
    the ``plan`` (``mlp_plan`` / ``decode_split_plan``)."""
    a = _bind(name, args, kw)
    if name == "flash_attention":
        q, k = a["q"], a["k"]
        B, Sq, H, Dh = q.shape
        Sk = k.shape[1]
        mt = _cdiv(Sq, 64)
        if q.dtype == torch.bfloat16 and Dh in (64, 128, 256):
            body, grid, block = "wgmma", (H, B, mt), 160
        else:
            body, grid, block = "cuda_core", (mt, H, B), _NT
        return dict(body=body, plan=None, launches=[dict(
            kernel=f"flash_fwd_{'wgmma' if body == 'wgmma' else 'simt'}",
            grid=grid, block=block, smem=_flash_smem(body, Dh))],
            tiles=[_tile("q", (Sq, Dh), (64, Dh), (mt, 1)),
                   _tile("k", (Sk, Dh), (64, Dh), (_cdiv(Sk, 64), 1))])
    if name in ("fused_mlp", "fused_mlp_routed"):
        x, wi = a["x"], a["wi"]
        D, F = x.shape[-1], wi.shape[1]
        if name == "fused_mlp":
            x3 = x if x.dim() == 3 else x[None]
            G, T_ = x3.shape[:2]
        else:
            G, T_ = a["idx"].shape
        plan, launches, tiles = _mlp_geometry(
            name, x.dtype, wi.dtype, G, T_, D, F, name == "fused_mlp_routed")
        return dict(body=plan.body, plan=plan, launches=launches, tiles=tiles)
    if name == "moe_gmm":
        x, wi, wo, wg = a["x"], a["wi"], a["wo"], a["wg"]
        x4 = x if x.dim() == 4 else x[None]
        B, E, C, D = x4.shape
        Fe = wi.shape[-1]
        plan, launches, tiles = _mlp_geometry(name, x.dtype, wi.dtype, B * E,
                                              C, D, Fe, False)
        if plan.body == "wgmma":      # the layouts the TMA maps read in place
            gmm_map(wi, (E, D, Fe), "wi")
            gmm_map(wo, (E, Fe, D), "wo")
            if wg is not None:
                gmm_map(wg, (E, D, Fe), "wg")
        return dict(body=plan.body, plan=plan, launches=launches, tiles=tiles)
    q = a["q"]
    B, _, H, Dh = q.shape
    if name == "decode_attention":
        k = a["k"]
        L, K = k.shape[1], k.shape[2]
        n_keys, ps = L, 1
    else:
        k = a["kp"]
        ps, K = k.shape[1], k.shape[2]
        n_keys = a["table"].shape[-1] * ps
    split, n_split = decode_split_plan(n_keys, ps)
    body = "mma_sync" if q.dtype == torch.bfloat16 else "cuda_core"
    return dict(body=body, plan=(split, n_split), launches=[
        dict(kernel=f"decode_split{'_mma' if body == 'mma_sync' else ''}",
             grid=(K, B, n_split * _cdiv(H // K, _GMAX)), block=_NT,
             smem=_decode_smem(q.dtype, k.dtype, Dh)),
        dict(kernel="decode_merge", grid=(H, B, 1), block=Dh, smem=0)],
        tiles=[_tile("keys", (n_keys, Dh), (split, Dh), (n_split, 1))])


def c_geometry(name: str, *args, **kw) -> list:
    """What the C launcher of wrapper ``name`` reports for this call (CUDA
    tensors): the wrapper runs as it does to launch, with the launcher's
    ``*_geometry`` entry in place of ``*_launch``, so nothing launches.
    Returns [((grid x, y, z), block threads, dynamic shared bytes), ...]."""
    kw = {k: v for k, v in kw.items() if k != "backend"}
    with geometry_only() as launches:
        _WRAPPERS[name](*args, backend="cuda", **kw)
    return list(launches)
