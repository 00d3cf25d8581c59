"""Published peak rates of the GPUs the port targets, for MFU and roofline
figures.

Dense (no sparsity) bf16 tensor-core rates and device-memory bandwidth
from NVIDIA's data sheets, at each part's full power limit. A card set
below its limit runs slower under load, so every figure computed against
these peaks should be reported beside ``nvidia-smi``'s ``power.limit``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Peak(NamedTuple):
    variant: str          # the part the figures assume
    bf16_flops: float     # dense bf16 FLOP/s
    hbm_bytes_per_s: float


# Matched in order against torch.cuda.get_device_name(); the first
# substring that occurs wins.
_PEAKS = (
    ("H100 PCIe", Peak("H100 PCIe (80 GB HBM2e, 350 W)", 756e12, 2.0e12)),
    ("H100 NVL", Peak("H100 NVL (94 GB HBM3, 400 W)", 835e12, 3.9e12)),
    ("H100", Peak("H100 SXM5 (80 GB HBM3, 700 W)", 989e12, 3.35e12)),
)


def peak_of(device_name: str) -> Optional[Peak]:
    """The peaks of the part named ``device_name``, or None if unknown."""
    for key, peak in _PEAKS:
        if key in device_name:
            return peak
    return None


def device_peak(device=None) -> Optional[Peak]:
    """The peaks of a CUDA device (the current one by default)."""
    return peak_of(torch.cuda.get_device_name(device))
