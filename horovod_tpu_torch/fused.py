"""Fusion of the optimizer update into per-dtype flat buffers.

Counterpart of :mod:`horovod_tpu.jax.fused` (``_layout_of``, ``_pack``,
``_unpack`` and ``fuse``). Tensors with fewer than ``threshold_elems``
elements (layer-norm scales, biases) are concatenated into one flat
buffer per parameter dtype, so an elementwise update runs over a couple
of large buffers instead of many tiny tensors; larger tensors keep their
own per-tensor update.

Correct for any elementwise transform (sgd, momentum, adam(w), ...): the
update of element ``i`` depends only on element ``i`` of the gradient and
the state. Transforms that look at per-parameter shapes must stay unfused.

A transform here is a :class:`Transform` over lists of tensors:
``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``, the shape of an optax transform.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence

import torch

DEFAULT_THRESHOLD_ELEMS = 4096


class Transform(NamedTuple):
    """An update rule on lists of tensors (optax's GradientTransformation
    shape): ``init(params) -> state``, ``update(grads, state, params) ->
    (updates, new_state)``."""

    init: Callable[[Sequence[torch.Tensor]], Any]
    update: Callable[..., Any]


class _FusedLayout(NamedTuple):
    """How a list of tensors packs into per-dtype buffers."""

    shapes: tuple      # per tensor
    group_keys: tuple  # dtypes with a buffer, in a fixed (sorted) order
    # per tensor: (dtype, offset) when packed, None when it passes through
    slots: tuple


def _layout_of(tensors: Sequence[torch.Tensor],
               threshold: int) -> _FusedLayout:
    offsets: dict = {}
    slots = []
    for t in tensors:
        dt, n = t.dtype, t.numel()
        if n >= threshold:
            slots.append(None)
            continue
        off = offsets.get(dt, 0)
        slots.append((dt, off))
        offsets[dt] = off + n
    return _FusedLayout(tuple(tuple(t.shape) for t in tensors),
                        tuple(sorted(offsets, key=str)), tuple(slots))


def _pack(tensors: Sequence[torch.Tensor], layout: _FusedLayout,
          cast_small: bool = False) -> List[torch.Tensor]:
    """Tensors -> ``[one flat buffer per group key..., large tensors...]``.
    ``cast_small`` casts packed tensors to the layout's dtype (bf16
    gradients of f32 parameters join the f32 buffer)."""
    groups: dict = {k: [] for k in layout.group_keys}
    big = []
    for t, slot in zip(tensors, layout.slots):
        if slot is None:
            big.append(t)
            continue
        dt = slot[0]
        groups[dt].append((t.to(dt) if cast_small else t).reshape(-1))
    bufs = [torch.cat(v) if len(v) > 1 else v[0]
            for v in (groups[k] for k in layout.group_keys)]
    return bufs + big


def _unpack(packed: Sequence[torch.Tensor],
            layout: _FusedLayout) -> List[torch.Tensor]:
    """Inverse of :func:`_pack`."""
    bufs = dict(zip(layout.group_keys, packed))
    big = iter(packed[len(layout.group_keys):])
    out = []
    for slot, shp in zip(layout.slots, layout.shapes):
        if slot is None:
            out.append(next(big))
            continue
        dt, off = slot
        n = 1
        for d in shp:
            n *= d
        out.append(bufs[dt][off: off + n].view(shp))
    return out


def fuse(optimizer: Transform,
         threshold_elems: int = DEFAULT_THRESHOLD_ELEMS) -> Transform:
    """Wrap an elementwise transform so tensors smaller than
    ``threshold_elems`` update through per-dtype flat buffers; larger
    tensors keep their own update. The state is the wrapped transform's
    state over the packed list."""
    # One layout per parameter list (keyed by shapes), built from the
    # PARAM dtypes: bf16 grads of f32 params land in the f32 buffers.
    layouts: dict = {}

    def _layout(params):
        key = tuple(tuple(t.shape) for t in params)
        layout = layouts.get(key)
        if layout is None:
            layout = layouts[key] = _layout_of(params, threshold_elems)
        return layout

    def init(params):
        return optimizer.init(_pack(params, _layout(params)))

    def update(grads, state, params: Sequence[torch.Tensor]):
        layout = _layout(params)
        pupd, new_state = optimizer.update(
            _pack(grads, layout, cast_small=True), state,
            _pack(params, layout))
        return _unpack(pupd, layout), new_state

    return Transform(init, update)
