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

On CUDA tensors hand-written kernels run. The forward has two routes:
bf16 inputs at a head dim of 64 or 128 (after padding) take the Hopper
kernel of ``csrc/flash_fwd_wgmma.cu`` (wgmma fed by a TMA/mbarrier ring);
float32 inputs and head dims up to 32 take ``flash_fwd_kernel`` of
``csrc/flash_attention.cu`` (mma.sync). dQ and dK/dV are that file's
kernels. The kernels have instances at head dims 32, 64 and 128; any other
head dim that is a multiple of 8, up to 128, is zero-padded to the next
instance (8 -> 32, 48 -> 64, 96 -> 128) and the outputs are sliced back.
That is an exact rewrite: zero columns change neither q.k nor the kept
columns of p.v, and the softmax scale stays ``d ** -0.5`` of the caller's
head dim. Head dims above 128 or not a multiple of 8 raise.

Precision on the CUDA path: the operands are bf16 and every product
accumulates in float32; float32 inputs are rounded to bf16 once, in the
wrapper, so their precision is bf16's, and o, dq, dk and dv come back in
the input dtype (lse is always float32), as in the JAX package.

On CPU tensors the plain PyTorch versions in this module run the same
recurrence in float32; they are also what the kernels are checked against.
Nothing on the CUDA path calls them.

Each kernel wrapper counts its launches in :data:`LAUNCHES`: the forward
under ``flash_fwd`` and under the route it took.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
#: Head dims with a kernel instance; others are padded up to one of these.
SUPPORTED_HEAD_DIMS = (32, 64, 128)
#: Head dims (after padding) that the wgmma forward takes in bf16.
WGMMA_HEAD_DIMS = (64, 128)
#: Input dtypes of the CUDA path (float32 is rounded to bf16).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
FWD_ROUTES = ("wgmma", "mma")

#: Launches of each CUDA kernel, incremented where the wrapper launches it:
#: ``flash_fwd`` counts every forward, ``flash_fwd_<route>`` those of a route.
LAUNCHES = {"flash_fwd": 0, "flash_fwd_wgmma": 0, "flash_fwd_mma": 0,
            "flash_dq": 0, "flash_dkv": 0}


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
_SIGNATURES = {
    "hvd_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "hvd_flash_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "hvd_flash_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                      _P],
}


_LIB = None
_WGMMA_LIB = None


def _bind(name, signatures, error_string):
    from horovod_tpu_torch.ops import _build

    lib = _build.load(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string = getattr(lib, error_string)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    """The library of ``csrc/flash_attention.cu``, built on first use, with
    its C signatures."""
    global _LIB
    if _LIB is None:
        _LIB = _bind("flash_attention", _SIGNATURES, "hvd_flash_error_string")
    return _LIB


def _wgmma_lib():
    """The library of ``csrc/flash_fwd_wgmma.cu``, built on first use."""
    global _WGMMA_LIB
    if _WGMMA_LIB is None:
        signature = {"hvd_flash_fwd_wgmma": _SIGNATURES["hvd_flash_fwd"]}
        _WGMMA_LIB = _bind("flash_fwd_wgmma", signature,
                           "hvd_flash_fwd_wgmma_error_string")
    return _WGMMA_LIB


def kernel_head_dim(d: int) -> int:
    """The head dim of the kernel instance that takes head dim ``d``: the
    smallest of :data:`SUPPORTED_HEAD_DIMS` that holds it. Raises
    ValueError where the CUDA path stops: ``d`` not a multiple of 8, or
    above 128."""
    if d <= 0 or d % 8 or d > SUPPORTED_HEAD_DIMS[-1]:
        raise ValueError(
            f"head_dim {d} has no CUDA kernel: the kernels take head dims "
            f"that are multiples of 8 up to {SUPPORTED_HEAD_DIMS[-1]}")
    return next(k for k in SUPPORTED_HEAD_DIMS if k >= d)


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel that takes inputs of ``dtype`` at head dim ``d``:
    ``"wgmma"`` for bf16 at a padded head dim of 64 or 128, else
    ``"mma"``. Decided on metadata only."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash attention: the CUDA kernels take bfloat16 "
                        f"or float32 inputs, got {dtype}")
    dp = kernel_head_dim(d)
    if dtype == torch.bfloat16 and dp in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def pad_head_dim(t, dp):
    """``t`` zero-padded along its last (head) dim to ``dp``; ``t`` itself
    when it has that width. Attention on padded q, k, v with the original
    head dim's scale is attention on the originals, zero-padded."""
    d = t.shape[-1]
    return t if d == dp else F.pad(t, (0, dp - d))


def _to_kernel(name, tensors, dp):
    """``tensors`` as the kernels take them: bf16, zero-padded along the
    head dim to ``dp``. A copy only where a cast or a pad is needed."""
    out = []
    for t in tensors:
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(f"{name}: the CUDA kernels take bfloat16 or "
                            f"float32 inputs, got {t.dtype}")
        out.append(pad_head_dim(t.to(torch.bfloat16), dp))
    return out


def _from_kernel(t, d, dtype):
    """A kernel output sliced back to head dim ``d`` in ``dtype``."""
    if t.shape[-1] != d:
        t = t[..., :d].contiguous()
    return t.to(dtype)


def _check(name, bf16=(), f32=()):
    """Validate what reaches the kernels, after the cast and the padding;
    returns (bh, s, d)."""
    ref = bf16[0]
    if ref.dim() != 3:
        raise ValueError(f"{name}: expected (batch*heads, seq, head_dim), "
                         f"got {tuple(ref.shape)}")
    bh, s, d = ref.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} has no CUDA kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    if bh > 65535:
        raise ValueError(f"{name}: batch*heads {bh} exceeds 65535")
    for t in bf16:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
        if tuple(t.shape) != (bh, s, d):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{(bh, s, d)}")
    for t in f32:
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, s):
            raise ValueError(f"{name}: row statistics must be float32 "
                             f"{(bh, s)}, got {t.dtype} {tuple(t.shape)}")
    for t in (*bf16, *f32):
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    return bh, s, d


def _raise_on(lib, name, code):
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _launch_fwd(q, k, v, causal, route=None):
    d = q.shape[-1]
    chosen = fwd_route(q.dtype, d) if route is None else route
    if chosen not in FWD_ROUTES:
        raise ValueError(f"flash_fwd: unknown route {chosen!r}")
    dp = kernel_head_dim(d)
    if chosen == "wgmma" and dp not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_fwd: the wgmma kernel takes head dims "
                         f"{WGMMA_HEAD_DIMS}, not {dp}")
    qk, kk, vk = _to_kernel("flash_fwd", (q, k, v), dp)
    bh, s, _ = _check("flash_fwd", bf16=(qk, kk, vk))
    lib = _wgmma_lib() if chosen == "wgmma" else _lib()
    fn = lib.hvd_flash_fwd_wgmma if chosen == "wgmma" else lib.hvd_flash_fwd
    o = torch.empty_like(qk)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), bh, s, dp, int(causal), d ** -0.5, stream)
    _raise_on(lib, "flash_fwd", code)
    LAUNCHES["flash_fwd"] += 1
    LAUNCHES["flash_fwd_" + chosen] += 1
    return _from_kernel(o, d, q.dtype), lse


def _launch_dq(q, k, v, lse, delta, do, causal):
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    qk, kk, vk, dok = _to_kernel("flash_dq", (q, k, v, do), dp)
    bh, s, _ = _check("flash_dq", bf16=(qk, kk, vk, dok), f32=(lse, delta))
    lib = _lib()
    dq = torch.empty_like(qk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_flash_dq(qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
                                dok.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq.data_ptr(), bh, s, dp,
                                int(causal), d ** -0.5, stream)
    _raise_on(lib, "flash_dq", code)
    LAUNCHES["flash_dq"] += 1
    return _from_kernel(dq, d, q.dtype)


def _launch_dkv(q, k, v, lse, delta, do, causal):
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    qk, kk, vk, dok = _to_kernel("flash_dkv", (q, k, v, do), dp)
    bh, s, _ = _check("flash_dkv", bf16=(qk, kk, vk, dok), f32=(lse, delta))
    lib = _lib()
    dk = torch.empty_like(kk)
    dv = torch.empty_like(vk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_flash_dkv(qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
                                 dok.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), bh, s, dp, int(causal),
                                 d ** -0.5, stream)
    _raise_on(lib, "flash_dkv", code)
    LAUNCHES["flash_dkv"] += 1
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
    tensors ``route`` ("wgmma" or "mma") forces one forward kernel, for
    measurement; by default :func:`fwd_route` picks it."""
    if _route("flash_fwd", q):
        return _launch_fwd(q, k, v, causal, route)
    return flash_fwd_reference(q, k, v, causal)


def flash_dq(q, k, v, lse, delta, do, causal: bool = False):
    """dQ on (batch*heads, seq, head_dim)."""
    if _route("flash_dq", q):
        return _launch_dq(q, k, v, lse, delta, do, causal)
    return flash_dq_reference(q, k, v, lse, delta, do, causal)


def flash_dkv(q, k, v, lse, delta, do, causal: bool = False):
    """``(dk, dv)`` on (batch*heads, seq, head_dim)."""
    if _route("flash_dkv", q):
        return _launch_dkv(q, k, v, lse, delta, do, causal)
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
