"""Gradient compression for the wire.

Counterpart of :mod:`horovod_tpu.jax.compression`: the ``none``, ``fp16``
and ``bf16`` cast compressors and :meth:`Compression.resolve`, which fails
fast on an unknown name. The block-scaled quantized policies (``int8``,
``int8_ef``, ``fp8``) are not ported yet: :meth:`Compression.resolve`
raises ``NotImplementedError`` for them rather than shipping full width.
"""

from __future__ import annotations

import os

import torch

from horovod_tpu_torch.common import topology as _topo


def _where_am_i() -> str:
    if _topo.is_initialized():
        return f"rank {_topo.rank()}"
    return f"pid {os.getpid()}"


class Compressor:
    """Interface: compress before the collective, decompress after."""

    @staticmethod
    def compress(tensor):
        """Returns ``(compressed_tensor, ctx)``; ``ctx`` is what
        :meth:`decompress` needs."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """Cast float tensors to float16 for the wire."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast float tensors to bfloat16 for the wire."""

    wire_dtype = torch.bfloat16


_NOT_PORTED = ("int8", "int8_ef", "fp8")


class Compression:
    """Option pack and the string registry behind :meth:`resolve`."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    _registry = {
        "none": NoneCompressor,
        "fp16": FP16Compressor,
        "bf16": BF16Compressor,
    }

    @classmethod
    def resolve(cls, spec, where: str = "compression"):
        """Normalize a policy spelling (a registry name, a compressor, or
        None), failing fast with the rank on anything else."""
        if spec is None:
            return cls._registry["none"]
        if isinstance(spec, str):
            if spec in _NOT_PORTED:
                raise NotImplementedError(
                    f"{where} policy {spec!r} (block-scaled quantized wire) "
                    "is not ported to horovod_tpu_torch yet")
            comp = cls._registry.get(spec)
            if comp is None:
                raise ValueError(
                    f"unknown {where} policy {spec!r} on {_where_am_i()}: "
                    f"expected one of {sorted(cls._registry)}")
            return comp
        if not (hasattr(spec, "compress") and hasattr(spec, "decompress")):
            raise ValueError(
                f"invalid {where} policy {spec!r} on {_where_am_i()}: "
                f"expected a Compression name ({sorted(cls._registry)}) "
                "or a Compressor")
        return spec
