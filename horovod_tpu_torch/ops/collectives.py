"""Collective verbs over ``torch.distributed``.

Counterpart of :mod:`horovod_tpu.ops.collectives` (eager path). A world of
one elides every collective: the verbs return their input unchanged and
launch nothing. Larger worlds run one NCCL (CUDA) or gloo (CPU)
collective per call; :func:`grouped_allreduce` fuses many tensors into one
flat buffer per dtype first, the reference's tensor fusion.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import topology as _topo


def _check_root(root_rank: int) -> int:
    st = _topo._require_init()
    root_rank = int(root_rank)
    if not 0 <= root_rank < st.size:
        raise ValueError(
            f"root_rank {root_rank} is out of range for world size "
            f"{st.size}")
    return root_rank


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None) -> torch.Tensor:
    """Sum (or mean) of ``tensor`` over all ranks, as a new tensor.

    An integer mean floor-divides and keeps the integer dtype; a float
    mean keeps the float dtype. ``name`` is accepted for API parity.
    """
    st = _topo._require_init()
    if st.size == 1:
        return tensor
    out = tensor.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    if average:
        if out.is_floating_point() or out.is_complex():
            out.div_(st.size)
        else:
            out = torch.div(out, st.size, rounding_mode="floor")
    return out


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank receives rank ``root_rank``'s value, as a new tensor."""
    root_rank = _check_root(root_rank)
    if _topo._require_init().size == 1:
        return tensor
    out = tensor.clone()
    dist.broadcast(out, src=root_rank)
    return out


def _grouped_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                   tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Apply ``fn(flat) -> flat`` to ``tensors`` fused into one flat buffer
    per dtype, order kept within each group."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idxs in by_dtype.values():
        group = [tensors[i] for i in idxs]
        flat = fn(torch.cat([t.reshape(-1) for t in group]))
        for i, piece in zip(idxs, torch.split(flat, [t.numel()
                                                     for t in group])):
            out[i] = piece.view(tensors[i].shape)
    return out


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: bool = True) -> List[torch.Tensor]:
    """Allreduce many tensors with one collective per dtype group."""
    if _topo._require_init().size == 1:
        return list(tensors)
    return _grouped_apply(lambda flat: allreduce(flat, average=average),
                          tensors)


def grouped_broadcast_(tensors: Sequence[torch.Tensor],
                       root_rank: int = 0) -> None:
    """Overwrite ``tensors`` in place with ``root_rank``'s values, one
    collective per dtype group."""
    root_rank = _check_root(root_rank)
    if _topo._require_init().size == 1:
        return
    tensors = list(tensors)
    with torch.no_grad():
        for t, new in zip(tensors, _grouped_apply(
                lambda flat: broadcast(flat, root_rank), tensors)):
            t.copy_(new)
