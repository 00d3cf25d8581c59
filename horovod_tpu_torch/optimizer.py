"""Data-parallel optimizer: gradient allreduce, then the update.

Counterpart of ``allreduce_pytree``, ``broadcast_parameters`` and
``DistributedOptimizer`` in :mod:`horovod_tpu.jax`, on the plain and the
``fused_update`` paths. The update rules are :class:`~horovod_tpu_torch.
fused.Transform`\\ s over lists of tensors, the shape of an optax
transform; :func:`adamw` is the arithmetic of ``optax.adamw``.

Typical loop::

    opt = DistributedOptimizer(adamw(1e-4, weight_decay=0.01),
                               fused_update=True)
    params = list(model.parameters())
    broadcast_parameters(params)
    state = opt.init(params)
    ...
    loss.backward()
    updates, state = opt.update([p.grad for p in params], state, params)
    apply_updates(params, updates)
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence

import torch

from horovod_tpu_torch.common import topology as _topo
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.fused import Transform, fuse
from horovod_tpu_torch.ops import collectives as _C


class AdamWState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Transform:
    """AdamW with decoupled weight decay on every tensor, step for step
    the arithmetic of ``optax.adamw`` (``scale_by_adam`` ->
    ``add_decayed_weights`` -> ``scale_by_learning_rate``); the returned
    updates are added to the parameters by :func:`apply_updates`."""

    def init(params):
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        grads = list(grads)
        count = state.count + 1
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(state.nu, b2))
        # Bias corrections in float32 with an integer power, as optax
        # computes them (a float power rounds differently from step 3).
        bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32)
                          ** torch.tensor(count, dtype=torch.int32))
                    for b in (b1, b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        upd = torch._foreach_add(upd, torch._foreach_mul(list(params),
                                                         weight_decay))
        upd = torch._foreach_mul(upd, -learning_rate)
        return upd, AdamWState(count, mu, nu)

    return Transform(init, update)


class Optimizer:
    """A transform bound to a list of parameters and its state, with the
    ``zero_grad()`` / ``step()`` surface of a ``torch.optim`` optimizer.
    ``step()`` reads each parameter's ``.grad`` (a missing gradient counts
    as zeros) and updates the parameters in place."""

    def __init__(self, transform: Transform, params):
        self.transform = transform
        self.params = list(params)
        self.state = transform.init(self.params)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        updates, self.state = self.transform.update(grads, self.state,
                                                    self.params)
        apply_updates(self.params, updates)


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` in place for every parameter (``optax.apply_updates``,
    which returns new arrays; updating in place keeps one copy of the
    parameters on the device)."""
    with torch.no_grad():
        torch._foreach_add_(list(params),
                            [u.to(p.dtype) for p, u in zip(params, updates)])


def allreduce_pytree(tensors: Sequence[torch.Tensor], average: bool = True,
                     compression=Compression.none) -> List[torch.Tensor]:
    """Allreduce a list of tensors, fused into one flat buffer per dtype,
    with a cast compressor around the collective. A world of one returns
    the tensors unchanged."""
    if _topo._require_init().size == 1:
        return list(tensors)
    comp = [compression.compress(t) for t in tensors]
    reduced = _C.grouped_allreduce([c for c, _ in comp], average=average)
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, comp)]


def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite every rank's parameters with ``root_rank``'s, in place.
    ``params`` is a ``state_dict``-style mapping or a sequence of
    tensors; it is returned."""
    tensors = list(params.values()) if hasattr(params, "values") else \
        list(params)
    _C.grouped_broadcast_(tensors, root_rank)
    return params


def DistributedOptimizer(optimizer: Transform, average: bool = True,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         fused_update: bool = False,
                         sharded_update: bool = False,
                         state_dtype=None) -> Transform:
    """Wrap ``optimizer`` so gradients are allreduced (fused per dtype,
    optionally cast-compressed) before its update.

    ``fused_update=True`` also runs the update itself on per-dtype flat
    buffers (:func:`horovod_tpu_torch.fused.fuse`); valid for elementwise
    rules such as :func:`adamw`.

    ``sharded_update``, a reduced ``state_dtype`` and
    ``backward_passes_per_step > 1`` are not ported yet and raise
    ``NotImplementedError``; so do the quantized compression policies.
    """
    compression = Compression.resolve(compression)
    if sharded_update:
        raise NotImplementedError(
            "sharded_update is not ported to horovod_tpu_torch yet")
    if state_dtype not in (None, "f32", "float32", torch.float32):
        raise NotImplementedError(
            "a reduced state_dtype is not ported to horovod_tpu_torch yet")
    if backward_passes_per_step != 1:
        raise NotImplementedError(
            "backward_passes_per_step > 1 is not ported to "
            "horovod_tpu_torch yet")
    if fused_update:
        optimizer = fuse(optimizer)

    def update(grads, state: Any, params):
        grads = allreduce_pytree(grads, average=average,
                                 compression=compression)
        return optimizer.update(grads, state, params)

    return Transform(optimizer.init, update)
