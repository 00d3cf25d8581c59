"""LM-head softmax cross-entropy over a large vocabulary, without the logits.

Counterpart of :mod:`horovod_tpu.ops.chunked_loss`. For BERT-base at 8 x
512 tokens the ``[4096, 30522]`` float32 logits are 500 MB; the stock
``lm_head -> F.cross_entropy`` path writes them, reads them back for the
log-sum-exp and the label, and materializes their gradient again. These
ops stream the vocabulary with an online log-sum-exp instead (the flash
trick applied to the classifier head): the forward keeps only the per-token
``lse``, and the backward recomputes each tile's logits and forms

    dlog = (exp(logits - lse) - onehot(label)) * g

on the fly, accumulating dx, dW and db.

Two versions, with the contract of the JAX package's pair:

- :func:`chunked_softmax_cross_entropy` ports the ``lax.scan`` version: plain
  PyTorch, the vocabulary in ``chunk`` columns, a backward that recomputes
  each chunk, so no ``[N, V]`` tensor is ever live. It runs on any device.
- :func:`fused_softmax_cross_entropy` ports the Pallas version. On CUDA
  tensors it runs the three kernels of ``csrc/chunked_loss.cu``; on CPU
  tensors it runs their plain versions in this module, which are also what
  the kernels are checked against. Nothing on the CUDA path calls them.

**The CUDA path** takes bf16 or float32 hidden states at any hidden size
from 1 to 1024. The kernels have instances at 256,
512, 768 and 1024; :func:`kernel_operands` zero-pads x and the head along
H to the next instance, which is an exact rewrite (zero columns add
nothing to x . W), and dx and dW are sliced back. Float32 hidden states
are rounded to bf16 there, once per call, and so is the head: the
products take bf16 operands and accumulate in float32, so the precision
is bf16's; dx comes back in the hidden states' dtype, as in the JAX
package. H above 1024 and float16 hidden states raise (the kernels keep
full-depth rows resident in shared memory; a loop over H lifts that).

**Weight layout.** The head is torch's ``lm_head.weight`` of shape (V, H),
the transpose of JAX's (H, V) ``kernel`` (``convert.py`` transposes it).
With it, ``x . W^T`` has the same "NT" shape as ``Q . K^T`` in the flash
kernels.

**Labels** must lie in ``[0, V)``. An out-of-range label is not detected:
its label logit is 0, its loss ``lse - 0`` and its gradient a pure
softmax, as in JAX. Mask ignored positions through the cotangent: clip
their labels into range and weight their losses with 0.

Rounding follows the JAX kernels: logits are ``x . W`` in the compute
dtype (``hidden``'s) with float32 accumulation, plus the float32 bias;
``lse = m + log(l)`` with ``l = 0`` guarded; dlog is float32 and rounded to
the compute dtype before both backward products; db sums the unrounded
dlog. Each kernel wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_CHUNK = 2048
#: Hidden sizes with a kernel instance; others are padded up to one of these.
SUPPORTED_HIDDEN = (256, 512, 768, 1024)
#: Hidden-state dtypes of the CUDA path (float32 is rounded to bf16).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

#: Launches of each CUDA kernel, incremented where the wrapper launches it.
LAUNCHES = {"ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}

_TILE = 32  # vocabulary rows of a streamed tile (csrc/chunked_loss.cu kBS)


def fwd_rows(h: int) -> int:
    """Token rows of a forward CTA at hidden size ``h``
    (``csrc/chunked_loss.cu`` fwd_rows)."""
    return 32 if h > 768 else 64


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels, on x (N, H), W (V, H)
# ---------------------------------------------------------------------------

def _logits(x, w, b):
    """``x . W^T + b`` in float32 from operands in the compute dtype."""
    return x.float() @ w.to(x.dtype).float().t() + b.float()


def _label_logits(logits, labels):
    """Each row's logit at its label; 0 where the label is out of range."""
    v = logits.shape[1]
    inside = (labels >= 0) & (labels < v)
    got = logits.gather(1, labels.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros_like(got))


def ce_fwd_reference(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``, both float32 (N,): plain version of the forward."""
    logits = _logits(x, w, b)
    m = logits.amax(dim=1)
    l = torch.exp(logits - m[:, None]).sum(dim=1)
    lse = m + torch.log(torch.where(l > 0, l, torch.ones_like(l)))
    return lse - _label_logits(logits, labels), lse


def ce_dlog_reference(x, w, b, labels, lse, g) -> torch.Tensor:
    """(softmax - onehot) * g in float32, (N, V): what both backward kernels
    recompute per tile (JAX's ``_ce_dlog``)."""
    logits = _logits(x, w, b)
    cols = torch.arange(logits.shape[1], device=x.device)
    onehot = (labels[:, None] == cols[None, :]).float()
    return (torch.exp(logits - lse[:, None]) - onehot) * g.float()[:, None]


def ce_dx_reference(x, w, b, labels, lse, g) -> torch.Tensor:
    """dx (N, H) in the compute dtype: plain version of the dx kernel."""
    dlog = ce_dlog_reference(x, w, b, labels, lse, g).to(x.dtype)
    return (dlog.float() @ w.to(x.dtype).float()).to(x.dtype)


def ce_dw_reference(x, w, b, labels, lse, g
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW (V, H), db (V,))`` in float32: plain version of the dW kernel."""
    dlog = ce_dlog_reference(x, w, b, labels, lse, g)
    dw = dlog.to(x.dtype).float().t() @ x.float()
    return dw, dlog.sum(dim=0)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "hvd_ce_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _P],
    "hvd_ce_dx": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hvd_ce_dw": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_LIB = None


def _lib():
    """The kernels' library, built on first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        from horovod_tpu_torch.ops import _build

        lib = _build.load("chunked_loss")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.hvd_ce_error_string.argtypes = [ctypes.c_int]
        lib.hvd_ce_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_hidden(h: int) -> int:
    """The hidden size of the kernel instance that takes hidden size ``h``:
    the smallest of :data:`SUPPORTED_HIDDEN` that holds it. Raises
    ValueError where the CUDA path stops: ``h`` not in 1..1024."""
    if not 0 < h <= SUPPORTED_HIDDEN[-1]:
        raise ValueError(
            f"hidden size {h} has no CUDA kernel: the kernels take hidden "
            f"sizes from 1 to {SUPPORTED_HIDDEN[-1]}")
    return next(k for k in SUPPORTED_HIDDEN if k >= h)


def pad_hidden(t, hp):
    """``t`` zero-padded along its last (hidden) dim to ``hp``; ``t`` itself
    when it has that width. Zero columns of x and W add nothing to x . W^T,
    so the loss, dx[:, :H] and dW[:, :H] of padded operands are those of
    the originals."""
    h = t.shape[-1]
    return t if h == hp else F.pad(t, (0, hp - h))


def kernel_operands(x, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H) and the head W (V, H) as the kernels take them: bf16,
    zero-padded along H to :func:`kernel_hidden`. A copy only where a cast
    or a pad is needed. Checks metadata only."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_softmax_cross_entropy: the CUDA kernels "
                        f"take bfloat16 or float32 hidden states, got "
                        f"{x.dtype}")
    if not w.dtype.is_floating_point:
        raise TypeError(f"fused_softmax_cross_entropy: the head must be "
                        f"floating point, got {w.dtype}")
    hp = kernel_hidden(x.shape[-1])
    return (pad_hidden(x.to(torch.bfloat16), hp).contiguous(),
            pad_hidden(w.to(torch.bfloat16), hp).contiguous())


def check_kernel_inputs(name, x, w, b, labels, lse=None, g=None
                        ) -> Tuple[int, int, int]:
    """Validate what reaches the kernels, after :func:`kernel_operands`;
    returns (N, H, V). Runs on tensor metadata only, so it is testable
    without a GPU."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: expected x (N, H) and W (V, H), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h = x.shape
    v = w.shape[0]
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"{name}: hidden size {h} has no CUDA kernel "
                         f"(supported: {SUPPORTED_HIDDEN})")
    if not 0 < n < 2 ** 31 or not 0 < v < 2 ** 31:
        raise ValueError(f"{name}: {n} tokens x {v} classes is out of range")
    for t, want, shape in ((x, torch.bfloat16, (n, h)),
                           (w, torch.bfloat16, (v, h)),
                           (b, torch.float32, (v,)),
                           (labels, torch.int64, (n,)),
                           (lse, torch.float32, (n,)),
                           (g, torch.float32, (n,))):
        if t is None:
            continue
        if t.dtype != want:
            raise TypeError(f"{name}: the CUDA kernel takes {want}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    return n, h, v


def _raise_on(lib, name, code):
    if code != 0:
        msg = lib.hvd_ce_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def vocab_splits(n: int, v: int, sms: int, rows: int = 64
                 ) -> Tuple[int, int]:
    """``(splits, tiles_per_split)`` of the forward's vocabulary for ``n``
    tokens in CTAs of ``rows``: the split count in 1..16 that wastes least
    of the last wave of CTAs (time ~ waves / splits), the smallest on
    ties."""
    row_tiles = -(-n // rows)
    tiles = -(-v // _TILE)
    best = min(range(1, min(16, tiles) + 1),
               key=lambda s: (-(-row_tiles * s // sms) / s, s))
    per = -(-tiles // best)
    return -(-tiles // per), per


def _launch_fwd(x, w, b, labels):
    n, h, v = check_kernel_inputs("ce_fwd", x, w, b, labels)
    lib = _lib()
    splits, per = vocab_splits(n, v, _sm_count(x.device.index), fwd_rows(h))
    parts = torch.empty((3, splits, n), dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    loss = torch.empty_like(lse)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_ce_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              labels.data_ptr(), parts[0].data_ptr(),
                              parts[1].data_ptr(), parts[2].data_ptr(),
                              lse.data_ptr(), loss.data_ptr(), n, v, h,
                              splits, per, stream)
    _raise_on(lib, "ce_fwd", code)
    LAUNCHES["ce_fwd"] += 1
    return loss, lse


def _launch_dx(x, w, b, labels, lse, g):
    n, h, v = check_kernel_inputs("ce_dx", x, w, b, labels, lse, g)
    lib = _lib()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_ce_dx(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                             dx.data_ptr(), n, v, h, stream)
    _raise_on(lib, "ce_dx", code)
    LAUNCHES["ce_dx"] += 1
    return dx


def _launch_dw(x, w, b, labels, lse, g):
    n, h, v = check_kernel_inputs("ce_dw", x, w, b, labels, lse, g)
    lib = _lib()
    dw = torch.empty((v, h), dtype=torch.float32, device=x.device)
    db = torch.empty(v, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hvd_ce_dw(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                             dw.data_ptr(), db.data_ptr(), n, v, h, stream)
    _raise_on(lib, "ce_dw", code)
    LAUNCHES["ce_dw"] += 1
    return dw, db


def _route(name, t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel on CUDA tensors, the plain version on CPU
# ---------------------------------------------------------------------------

def ce_fwd(x, w, b, labels):
    """``(loss, lse)`` of x (N, H) against W (V, H), b (V,), labels (N,)."""
    if _route("ce_fwd", x):
        return _launch_fwd(x, w, b, labels)
    return ce_fwd_reference(x, w, b, labels)


def ce_dx(x, w, b, labels, lse, g):
    """dx (N, H) in x's dtype for the per-token cotangent g (N,)."""
    if _route("ce_dx", x):
        return _launch_dx(x, w, b, labels, lse, g)
    return ce_dx_reference(x, w, b, labels, lse, g)


def ce_dw(x, w, b, labels, lse, g):
    """``(dW (V, H), db (V,))`` in float32 for the cotangent g (N,)."""
    if _route("ce_dw", x):
        return _launch_dw(x, w, b, labels, lse, g)
    return ce_dw_reference(x, w, b, labels, lse, g)


class _Fused(torch.autograd.Function):
    """Per-token losses through the three kernels. The head is cast to the
    compute dtype once per call (47 MB in bf16 for BERT-base) and that copy
    is saved for the backward, with x, the labels and lse. On CUDA the
    compute dtype is bf16 and x and the head are padded to the kernels'
    hidden size (:func:`kernel_operands`); dx and dW are sliced back."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels):
        x = hidden.reshape(-1, hidden.shape[-1]).contiguous()
        if x.is_cuda:
            x, w = kernel_operands(x, weight)
        else:
            w = weight.to(hidden.dtype).contiguous()
        b = bias.float().contiguous()
        lab = labels.reshape(-1).to(torch.int64).contiguous()
        loss, lse = ce_fwd(x, w, b, lab)
        ctx.save_for_backward(x, w, b, lab, lse)
        ctx.hidden_shape = hidden.shape
        ctx.dtypes = (hidden.dtype, weight.dtype, bias.dtype)
        return loss.view(hidden.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        x, w, b, lab, lse = ctx.saved_tensors
        g = g.reshape(-1).float().contiguous()
        dx = dw = db = None
        h = ctx.hidden_shape[-1]
        if ctx.needs_input_grad[0]:
            dx = _unpad(ce_dx(x, w, b, lab, lse, g), h).to(ctx.dtypes[0])
            dx = dx.view(ctx.hidden_shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = ce_dw(x, w, b, lab, lse, g)
            dw, db = _unpad(dw, h).to(ctx.dtypes[1]), db.to(ctx.dtypes[2])
        return dx, dw, db, None


def _unpad(t, h):
    """The first ``h`` columns of a kernel output."""
    return t if t.shape[-1] == h else t[:, :h].contiguous()


def fused_softmax_cross_entropy(hidden, weight, bias, labels,
                                block_n: int = 512, block_v: int = 1024):
    """Per-token losses ``logsumexp(h W^T + b) - (h W^T + b)[label]``, in
    float32 with the leading shape of ``hidden``.

    hidden: (..., H) in the compute dtype (bf16 or float32 on CUDA, where
    H is at most 1024);
    weight: (V, H), torch's ``lm_head.weight`` (the transpose of JAX's
    kernel); bias: (V,); labels: (...) integers in ``[0, V)``. dx comes
    back in ``hidden``'s dtype, dW and db in the parameters'. ``block_n``
    and ``block_v`` are the JAX version's tile sizes and must be positive;
    the CUDA kernels choose their own tiles and handle any N and V.
    """
    if block_n <= 0 or block_v <= 0:
        raise ValueError(f"block sizes must be positive, got "
                         f"({block_n}, {block_v})")
    return _Fused.apply(hidden, weight, bias, labels)


# ---------------------------------------------------------------------------
# The scan version: plain PyTorch, chunk by chunk
# ---------------------------------------------------------------------------

class _Chunked(torch.autograd.Function):
    """Online log-sum-exp over vocabulary chunks; the backward recomputes
    each chunk's logits, so at most (N, chunk) of them are live."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, chunk):
        x = hidden.reshape(-1, hidden.shape[-1])
        lab = labels.reshape(-1)
        n, v = x.shape[0], weight.shape[0]
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros(n, device=x.device)
        lbl = torch.zeros(n, device=x.device)
        for c0 in range(0, v, chunk):
            logits = _logits(x, weight[c0:c0 + chunk], bias[c0:c0 + chunk])
            new_m = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - new_m) + torch.exp(
                logits - new_m[:, None]).sum(dim=1)
            m = new_m
            local = lab - c0
            inside = (local >= 0) & (local < logits.shape[1])
            got = logits.gather(
                1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
            lbl = torch.where(inside, got, lbl)
        lse = torch.log(s) + m
        ctx.save_for_backward(x, weight, bias, lab, lse)
        ctx.chunk = chunk
        ctx.hidden_shape = hidden.shape
        return (lse - lbl).view(hidden.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, lab, lse = ctx.saved_tensors
        chunk = ctx.chunk
        g = g.reshape(-1).float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(weight.shape, dtype=torch.float32, device=x.device)
        db = torch.empty(bias.shape, dtype=torch.float32, device=x.device)
        for c0 in range(0, weight.shape[0], chunk):
            wc = weight[c0:c0 + chunk]
            dlog = ce_dlog_reference(x, wc, bias[c0:c0 + chunk], lab - c0, lse,
                                     g)
            dlog_c = dlog.to(x.dtype).float()
            dx += dlog_c @ wc.to(x.dtype).float()
            dw[c0:c0 + chunk] = dlog_c.t() @ x.float()
            db[c0:c0 + chunk] = dlog.sum(dim=0)
        return (dx.to(x.dtype).view(ctx.hidden_shape), dw.to(weight.dtype),
                db.to(bias.dtype), None, None)


def chunked_softmax_cross_entropy(hidden, weight, bias, labels,
                                  chunk: int = DEFAULT_CHUNK):
    """Per-token losses, same contract as
    :func:`fused_softmax_cross_entropy`, in plain PyTorch: the vocabulary
    streams in ``chunk`` columns and no (N, V) tensor is ever live."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return _Chunked.apply(hidden, weight, bias, labels, chunk)
