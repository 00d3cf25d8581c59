"""Flash attention, forward and backward, with hand-written Hopper kernels.

Counterpart of :mod:`horovod_tpu.ops.flash_attention`. Exact attention
that never materializes the (s x s) probabilities: the forward streams
K/V tiles through an online softmax and saves only the output and the
per-row log-sum-exp; the backward recomputes the probabilities from them
and splits into one kernel for dQ (looping over key tiles) and one for
dK/dV (looping over query tiles), per the flash backward recurrence:

    p_ij = exp(q_i·k_j·scale − lse_i)
    dv_j = Σ_i p_ij · do_i
    ds_ij = p_ij · (do_i·v_j − Δ_i),   Δ_i = do_i·o_i
    dq_i = Σ_j ds_ij · k_j · scale
    dk_j = Σ_i ds_ij · q_i · scale

On CUDA tensors hand-written kernels run, on one of two routes that the
forward and its backward share (:func:`fwd_route`, :func:`bwd_route`):

=================================  ========  ===============================
input                              route     instance (padded head dim)
=================================  ========  ===============================
bf16, padded head dim 32           mma       32
bf16, padded head dim 64/128/256   wgmma     the same
float16, any head dim up to 256    wgmma     max(64, padded head dim)
float32, head dim up to 128        mma       32/64/128 (rounded to bf16)
float32, head dim 129-256          wgmma     256 (rounded to bf16)
=================================  ========  ===============================

The ``wgmma`` route is the Hopper kernels of ``csrc/flash_fwd_wgmma.cu``
(forward) and ``csrc/flash_bwd_wgmma.cu`` (dQ, dK/dV): wgmma fed by a
TMA/mbarrier ring, with bf16 or f16 operands. The ``mma`` route is the
mma.sync kernels of ``csrc/flash_attention.cu`` (bf16 operands). Any head
dim from 1 to 256 is zero-padded to the next instance (12 -> 32,
48 -> 64, 136 -> 256) and the outputs are sliced back. That is an exact
rewrite: zero columns change neither q.k nor the kept columns of p.v, and
the softmax scale stays ``d ** -0.5`` of the caller's head dim. Head dims
above 256 and dtypes other than these three raise.

Precision on the CUDA path: every product accumulates in float32 from
16-bit operands; float16 inputs are computed in float16, float32 inputs
are rounded to bf16 once, in the wrapper, so their precision is bf16's;
o, dq, dk and dv come back in the input dtype (lse is always float32), as
in the JAX package.

On CPU tensors the plain PyTorch versions in this module run the same
recurrence in float32; they are also what the kernels are checked against.
Nothing on the CUDA path calls them.

Each kernel wrapper counts its launches in :data:`LAUNCHES`: under its
name (``flash_fwd``, ``flash_dq``, ``flash_dkv``) and under the route it
took (``flash_dq_wgmma``, ...).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
#: Head dims with a kernel instance; others are padded up to one of these.
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
#: Instances of the mma.sync kernels (bf16 operands).
MMA_HEAD_DIMS = (32, 64, 128)
#: Instances of the wgmma kernels (bf16 or f16 operands).
WGMMA_HEAD_DIMS = (64, 128, 256)
#: Input dtypes of the CUDA path (float32 is rounded to bf16).
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
ROUTES = ("wgmma", "mma")
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")

#: Launches of each CUDA kernel, incremented where the wrapper launches it:
#: ``flash_fwd`` counts every forward, ``flash_fwd_<route>`` those of a
#: route; the same for ``flash_dq`` and ``flash_dkv``.
LAUNCHES = {f"{kernel}{route}": 0 for kernel in KERNELS
            for route in ("", "_wgmma", "_mma")}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions, on (batch*heads, seq, head_dim)
# ---------------------------------------------------------------------------

def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def _scores(q, k, causal, scale=None):
    """Scaled logits in float32 with the causal mask applied."""
    s = q.shape[-2]
    logits = (q.float() * _scale(q, scale)) @ k.float().transpose(-1, -2)
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = logits.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    return logits


def flash_fwd_reference(q, k, v, causal: bool,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o in the input dtype, lse (batch*heads, seq) in f32.
    ``scale`` defaults to ``head_dim ** -0.5`` (given explicitly for inputs
    padded along the head dim, as the kernels' callers give it)."""
    logits = _scores(q, k, causal, scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = (p @ v.float()) / safe
    return o.to(q.dtype), (m + torch.log(safe)).squeeze(-1)


def _probs(q, k, lse, causal, scale):
    return torch.exp(_scores(q, k, causal, scale) - lse.unsqueeze(-1))


def flash_dq_reference(q, k, v, lse, delta, do, causal: bool,
                       scale: Optional[float] = None) -> torch.Tensor:
    """dQ from the saved row statistics (plain version of the dQ kernel)."""
    p = _probs(q, k, lse, causal, scale)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta.unsqueeze(-1))
    return (ds @ k.float() * _scale(q, scale)).to(q.dtype)


def flash_dkv_reference(q, k, v, lse, delta, do, causal: bool,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from the saved row statistics (plain version of the
    dK/dV kernel)."""
    p = _probs(q, k, lse, causal, scale)
    dv = p.transpose(-1, -2) @ do.float()
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta.unsqueeze(-1))
    dk = ds.transpose(-1, -2) @ (q.float() * _scale(q, scale))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(do, o) -> torch.Tensor:
    """Δ_i = do_i·o_i in float32, shape (batch*heads, seq)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool):
    """``(dq, dk, dv)``: the plain backward."""
    delta = attention_delta(do, o)
    dq = flash_dq_reference(q, k, v, lse, delta, do, causal)
    dk, dv = flash_dkv_reference(q, k, v, lse, delta, do, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_DQ = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_DKV = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
#: Each kernel library (``csrc/<name>.cu``): its error-string function and
#: its entry points with their C signatures.
LIBRARIES = {
    "flash_attention": ("hvd_flash_error_string", {
        "hvd_flash_fwd": _FWD, "hvd_flash_dq": _DQ, "hvd_flash_dkv": _DKV}),
    "flash_fwd_wgmma": ("hvd_flash_fwd_wgmma_error_string", {
        "hvd_flash_fwd_wgmma": _FWD, "hvd_flash_fwd_wgmma_f16": _FWD}),
    "flash_bwd_wgmma": ("hvd_flash_bwd_wgmma_error_string", {
        "hvd_flash_dq_wgmma": _DQ, "hvd_flash_dq_wgmma_f16": _DQ,
        "hvd_flash_dkv_wgmma": _DKV, "hvd_flash_dkv_wgmma_f16": _DKV}),
}
# (kernel, route) -> (library, entry point for bf16; f16 adds "_f16")
_ENTRIES = {
    ("flash_fwd", "mma"): ("flash_attention", "hvd_flash_fwd"),
    ("flash_dq", "mma"): ("flash_attention", "hvd_flash_dq"),
    ("flash_dkv", "mma"): ("flash_attention", "hvd_flash_dkv"),
    ("flash_fwd", "wgmma"): ("flash_fwd_wgmma", "hvd_flash_fwd_wgmma"),
    ("flash_dq", "wgmma"): ("flash_bwd_wgmma", "hvd_flash_dq_wgmma"),
    ("flash_dkv", "wgmma"): ("flash_bwd_wgmma", "hvd_flash_dkv_wgmma"),
}
_LIBS: dict = {}


def library(name):
    """The library of ``csrc/<name>.cu`` (one of :data:`LIBRARIES`), built
    on first use, with its C signatures."""
    lib = _LIBS.get(name)
    if lib is None:
        from horovod_tpu_torch.ops import _build

        error_string, signatures = LIBRARIES[name]
        lib = _build.load(name)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string = getattr(lib, error_string)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check_dtype(name, dtype):
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take bfloat16, float16 "
                        f"or float32 inputs, got {dtype}")


def kernel_head_dim(d: int) -> int:
    """The smallest of :data:`SUPPORTED_HEAD_DIMS` that holds head dim
    ``d``. Raises ValueError where the CUDA path stops: ``d`` not in
    1..256."""
    if not 0 < d <= SUPPORTED_HEAD_DIMS[-1]:
        raise ValueError(
            f"head_dim {d} has no CUDA kernel: the kernels take head dims "
            f"from 1 to {SUPPORTED_HEAD_DIMS[-1]}")
    return next(k for k in SUPPORTED_HEAD_DIMS if k >= d)


def kernel_instance(dtype: torch.dtype, d: int) -> int:
    """The head dim of the kernel instance that takes inputs of ``dtype``
    at head dim ``d`` (they are zero-padded to it): the next instance, and
    at least 64 for float16, which only the wgmma kernels take."""
    _check_dtype("flash attention", dtype)
    dp = kernel_head_dim(d)
    return max(dp, WGMMA_HEAD_DIMS[0]) if dtype == torch.float16 else dp


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The kernel route of inputs of ``dtype`` at head dim ``d``: the wgmma
    kernels (``"wgmma"``) for float16, for bf16 at a padded head dim of
    64, 128 or 256 and for float32 above 128; the mma.sync kernels
    (``"mma"``) for bf16 at 32 and float32 up to 128. Decided on metadata
    only."""
    dp = kernel_instance(dtype, d)
    if dtype == torch.float16 or dp > MMA_HEAD_DIMS[-1]:
        return "wgmma"
    if dtype == torch.bfloat16 and dp in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The route of the dQ and dK/dV kernels: that of the forward."""
    return fwd_route(dtype, d)


def _plan(name, dtype, d, route):
    """(route, instance head dim, operand dtype) of one kernel call;
    ``route`` forces a route, which must have the instance."""
    chosen = fwd_route(dtype, d) if route is None else route
    if chosen not in ROUTES:
        raise ValueError(f"{name}: unknown route {chosen!r}")
    dp = kernel_instance(dtype, d)
    if chosen == "wgmma" and dp not in WGMMA_HEAD_DIMS:
        raise ValueError(f"{name}: the wgmma kernels take head dims "
                         f"{WGMMA_HEAD_DIMS}, not {dp}")
    if chosen == "mma" and (dtype == torch.float16 or dp not in MMA_HEAD_DIMS):
        raise ValueError(f"{name}: the mma.sync kernels take bfloat16 or "
                         f"float32 at head dims {MMA_HEAD_DIMS}, not "
                         f"{dtype} at {dp}")
    kdtype = torch.float16 if dtype == torch.float16 else torch.bfloat16
    return chosen, dp, kdtype


def pad_head_dim(t, dp):
    """``t`` zero-padded along its last (head) dim to ``dp``; ``t`` itself
    when it has that width. Attention on padded q, k, v with the original
    head dim's scale is attention on the originals, zero-padded."""
    d = t.shape[-1]
    return t if d == dp else F.pad(t, (0, dp - d))


def _to_kernel(name, tensors, dp, kdtype=torch.bfloat16):
    """``tensors`` as the kernels take them: in ``kdtype`` (bf16, or f16 for
    float16 inputs), zero-padded along the head dim to ``dp``. A copy only
    where a cast or a pad is needed."""
    out = []
    for t in tensors:
        _check_dtype(name, t.dtype)
        out.append(pad_head_dim(t.to(kdtype), dp))
    return out


def _from_kernel(t, d, dtype):
    """A kernel output sliced back to head dim ``d`` in ``dtype``."""
    if t.shape[-1] != d:
        t = t[..., :d].contiguous()
    return t.to(dtype)


def _check(name, operands=(), f32=()):
    """Validate what reaches the kernels, after the cast and the padding:
    ``operands`` of one 16-bit type (bf16 or f16) at an instance head dim,
    ``f32`` row statistics; returns (bh, s, d)."""
    ref = operands[0]
    if ref.dim() != 3:
        raise ValueError(f"{name}: expected (batch*heads, seq, head_dim), "
                         f"got {tuple(ref.shape)}")
    bh, s, d = ref.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} has no CUDA kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    if bh > 65535:
        raise ValueError(f"{name}: batch*heads {bh} exceeds 65535")
    if ref.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: the CUDA kernels take bfloat16 or float16 "
                        f"operands, got {ref.dtype}")
    for t in operands:
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: the operands must have one type, got "
                            f"{t.dtype} beside {ref.dtype}")
        if tuple(t.shape) != (bh, s, d):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{(bh, s, d)}")
    for t in f32:
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, s):
            raise ValueError(f"{name}: row statistics must be float32 "
                             f"{(bh, s)}, got {t.dtype} {tuple(t.shape)}")
    for t in (*operands, *f32):
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    return bh, s, d


def _launch(name, route, inputs, stats, causal, n_out):
    """One kernel call on CUDA tensors: ``inputs`` (q, k, v[, do]) cast and
    padded for the route, ``stats`` the float32 row statistics. Returns
    ``n_out`` outputs shaped like the padded operands (and, for the
    forward, lse) as the kernel wrote them."""
    q = inputs[0]
    d = q.shape[-1]
    chosen, dp, kdtype = _plan(name, q.dtype, d, route)
    ops = _to_kernel(name, inputs, dp, kdtype)
    bh, s, _ = _check(name, operands=ops, f32=stats)
    lib_name, entry = _ENTRIES[name, chosen]
    lib = library(lib_name)
    fn = getattr(lib, entry + ("_f16" if kdtype == torch.float16 else ""))
    outs = [torch.empty_like(ops[0]) for _ in range(n_out)]
    if name == "flash_fwd":
        outs.append(torch.empty((bh, s), dtype=torch.float32,
                                device=q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*(t.data_ptr() for t in (*ops, *stats, *outs)), bh, s, dp,
                  int(causal), d ** -0.5, stream)
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_{chosen}"] += 1
    return outs


def _launch_fwd(q, k, v, causal, route=None):
    o, lse = _launch("flash_fwd", route, (q, k, v), (), causal, 1)
    return _from_kernel(o, q.shape[-1], q.dtype), lse


def _launch_dq(q, k, v, lse, delta, do, causal, route=None):
    (dq,) = _launch("flash_dq", route, (q, k, v, do), (lse, delta), causal,
                    1)
    return _from_kernel(dq, q.shape[-1], q.dtype)


def _launch_dkv(q, k, v, lse, delta, do, causal, route=None):
    dk, dv = _launch("flash_dkv", route, (q, k, v, do), (lse, delta),
                     causal, 2)
    d = q.shape[-1]
    return _from_kernel(dk, d, k.dtype), _from_kernel(dv, d, v.dtype)


def _route(name, t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel on CUDA tensors, the plain version on CPU
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, causal: bool = False, route: Optional[str] = None):
    """Forward on (batch*heads, seq, head_dim): ``(o, lse)``. On CUDA
    tensors ``route`` ("wgmma" or "mma") forces one kernel route, for
    measurement; by default :func:`fwd_route` picks it."""
    if _route("flash_fwd", q):
        return _launch_fwd(q, k, v, causal, route)
    return flash_fwd_reference(q, k, v, causal)


def flash_dq(q, k, v, lse, delta, do, causal: bool = False,
             route: Optional[str] = None):
    """dQ on (batch*heads, seq, head_dim); ``route`` as for
    :func:`flash_fwd` (by default :func:`bwd_route`)."""
    if _route("flash_dq", q):
        return _launch_dq(q, k, v, lse, delta, do, causal, route)
    return flash_dq_reference(q, k, v, lse, delta, do, causal)


def flash_dkv(q, k, v, lse, delta, do, causal: bool = False,
              route: Optional[str] = None):
    """``(dk, dv)`` on (batch*heads, seq, head_dim); ``route`` as for
    :func:`flash_fwd`."""
    if _route("flash_dkv", q):
        return _launch_dkv(q, k, v, lse, delta, do, causal, route)
    return flash_dkv_reference(q, k, v, lse, delta, do, causal)


class _Flash(torch.autograd.Function):
    """Attention on (batch*heads, seq, head_dim) with the flash backward.
    Saves q, k, v, o and lse — never the (s x s) probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(do, o)
        dq = flash_dq(q, k, v, lse, delta, do, ctx.causal)
        dk, dv = flash_dkv(q, k, v, lse, delta, do, ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, bias=None, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """Exact attention, flash-style, differentiable. Shapes
    (batch, seq, heads, head_dim), the model's ``attention_fn`` contract.
    ``bias`` is not supported. Explicit ``block_q``/``block_k`` must divide
    ``seq`` (the contract of the JAX version); the CUDA kernels choose
    their own 64-row tiles and handle any ``seq``."""
    if bias is not None:
        raise NotImplementedError(
            "flash_attention does not take a bias; use "
            "models.transformer.dot_product_attention for biased attention")
    b, s, h, d = q.shape
    block_q = s if block_q is None else min(block_q, s)
    block_k = s if block_k is None else min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq len {s} must be divisible by block sizes "
            f"({block_q}, {block_k})")

    def to_bhsd(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    out = _Flash.apply(to_bhsd(q), to_bhsd(k), to_bhsd(v), causal)
    return out.view(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention_causal(q, k, v, bias=None, **kw):
    """Causal variant matching the ``attention_fn`` signature."""
    return flash_attention(q, k, v, bias, causal=True, **kw)
