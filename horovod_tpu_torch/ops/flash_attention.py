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

On CUDA tensors the three kernels of ``csrc/flash_attention.cu`` run
(bf16, head dim 32 or 64; anything else raises). On CPU tensors the plain
PyTorch versions in this module run the same recurrence in float32; they
are also what the kernels are checked against. Nothing on the CUDA path
calls them.

Each kernel wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64)

#: Launches of each CUDA kernel, incremented where the wrapper launches it.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions, on (batch*heads, seq, head_dim)
# ---------------------------------------------------------------------------

def _scores(q, k, causal):
    """Scaled logits in float32 with the causal mask applied."""
    s, d = q.shape[-2], q.shape[-1]
    logits = (q.float() * d ** -0.5) @ k.float().transpose(-1, -2)
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = logits.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    return logits


def flash_fwd_reference(q, k, v, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o in the input dtype, lse (batch*heads, seq) in f32."""
    logits = _scores(q, k, causal)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = (p @ v.float()) / safe
    return o.to(q.dtype), (m + torch.log(safe)).squeeze(-1)


def _probs(q, k, lse, causal):
    return torch.exp(_scores(q, k, causal) - lse.unsqueeze(-1))


def flash_dq_reference(q, k, v, lse, delta, do, causal: bool) -> torch.Tensor:
    """dQ from the saved row statistics (plain version of the dQ kernel)."""
    p = _probs(q, k, lse, causal)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta.unsqueeze(-1))
    return (ds @ k.float() * q.shape[-1] ** -0.5).to(q.dtype)


def flash_dkv_reference(q, k, v, lse, delta, do, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from the saved row statistics (plain version of the
    dK/dV kernel)."""
    p = _probs(q, k, lse, causal)
    dv = p.transpose(-1, -2) @ do.float()
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta.unsqueeze(-1))
    dk = ds.transpose(-1, -2) @ (q.float() * q.shape[-1] ** -0.5)
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


def _lib():
    """The kernels' library, built on first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        from horovod_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.hvd_flash_error_string.argtypes = [ctypes.c_int]
        lib.hvd_flash_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name, bf16=(), f32=()):
    """Validate what the kernels take; returns (bh, s, d)."""
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
        msg = lib.hvd_flash_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _launch_fwd(q, k, v, causal):
    bh, s, d = _check("flash_fwd", bf16=(q, k, v))
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), bh, s, d,
                                 int(causal), d ** -0.5, stream)
    _raise_on(lib, "flash_fwd", code)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _launch_dq(q, k, v, lse, delta, do, causal):
    bh, s, d = _check("flash_dq", bf16=(q, k, v, do), f32=(lse, delta))
    lib = _lib()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq.data_ptr(), bh, s, d,
                                int(causal), d ** -0.5, stream)
    _raise_on(lib, "flash_dq", code)
    LAUNCHES["flash_dq"] += 1
    return dq


def _launch_dkv(q, k, v, lse, delta, do, causal):
    bh, s, d = _check("flash_dkv", bf16=(q, k, v, do), f32=(lse, delta))
    lib = _lib()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), bh, s, d, int(causal),
                                 d ** -0.5, stream)
    _raise_on(lib, "flash_dkv", code)
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


def _route(name, t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel on CUDA tensors, the plain version on CPU
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, causal: bool = False):
    """Forward on (batch*heads, seq, head_dim): ``(o, lse)``."""
    if _route("flash_fwd", q):
        return _launch_fwd(q, k, v, causal)
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
