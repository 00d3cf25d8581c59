"""The flash-attention routes of the backward, float16 and head dims up to
256, and the build cache's coverage of the kernels' shared header.

Routes, instances, casts and refusals are decided in Python from tensor
metadata before any launch, so they are checked here on CPU tensors: the
dQ and dK/dV kernels take the route of the forward (``bwd_route`` ==
``fwd_route``) for every row of the route table in
``horovod_tpu_torch/ops/flash_attention.py``; float16 inputs stay float16
on their way to the wgmma kernels; head dims 136 to 256 reach the d = 256
instance; and what no kernel takes raises. The numerics of those inputs
are checked against the JAX package in ``test_torch_flash_wide.py``.
"""

import os
import shutil

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# (dtype, head dim) -> (route, instance head dim, dtype of the operands)
ROUTE_TABLE = {
    "bf16_32": (BF16, 32, "mma", 32, BF16),
    "bf16_12": (BF16, 12, "mma", 32, BF16),
    "bf16_64": (BF16, 64, "wgmma", 64, BF16),
    "bf16_128": (BF16, 128, "wgmma", 128, BF16),
    "bf16_136": (BF16, 136, "wgmma", 256, BF16),
    "bf16_256": (BF16, 256, "wgmma", 256, BF16),
    "f16_16": (F16, 16, "wgmma", 64, F16),
    "f16_100": (F16, 100, "wgmma", 128, F16),
    "f16_256": (F16, 256, "wgmma", 256, F16),
    "f32_64": (F32, 64, "mma", 64, BF16),
    "f32_128": (F32, 128, "mma", 128, BF16),
    "f32_129": (F32, 129, "wgmma", 256, BF16),
}


@pytest.mark.parametrize("case", ROUTE_TABLE)
def test_backward_takes_the_forward_route(case):
    """Each kernel's route, instance and operand dtype; what reaches the
    kernel passes ``_check``."""
    dtype, d, route, dp, kdtype = ROUTE_TABLE[case]
    assert tfa.fwd_route(dtype, d) == tfa.bwd_route(dtype, d) == route
    assert tfa.kernel_instance(dtype, d) == dp
    for kernel in tfa.KERNELS:
        assert tfa._plan(kernel, dtype, d, None) == (route, dp, kdtype)
    q = torch.ones(2, 16, d, dtype=dtype)
    (qk,) = tfa._to_kernel("t", (q,), dp, kdtype)
    assert qk.dtype == kdtype and qk.shape == (2, 16, dp)
    stats = (torch.zeros(2, 16),)
    assert tfa._check("t", operands=(qk, qk), f32=stats) == (2, 16, dp)


def test_float16_stays_float16():
    """float16 inputs reach the kernels as float16 (computed natively, never
    rounded to bf16), zero-padded to the instance; outputs slice back."""
    q = torch.randn(2, 16, 40).to(F16)
    (qk,) = tfa._to_kernel("t", (q,), 64, F16)
    assert qk.dtype == F16 and torch.equal(qk[..., :40], q)
    assert not qk[..., 40:].any()
    out = tfa._from_kernel(qk, 40, F16)
    assert out.dtype == F16 and torch.equal(out, q)


@pytest.mark.parametrize("dtype", [BF16, F16])
def test_check_accepts_head_dim_256(dtype):
    t = torch.zeros(3, 70, 256, dtype=dtype)
    assert tfa._check("t", operands=(t, t, t, t),
                      f32=(torch.zeros(3, 70),) * 2) == (3, 70, 256)


@pytest.mark.parametrize("dtype,d,exc", [
    (BF16, 0, ValueError), (BF16, 264, ValueError),
    (torch.float64, 64, TypeError)])
def test_refusals_name_the_limit(dtype, d, exc):
    """Head dims of 0 or above 256 and float64 raise before any launch, in
    both directions, with a message that names the limit."""
    for route_of in (tfa.fwd_route, tfa.bwd_route):
        with pytest.raises(exc, match="256|bfloat16"):
            route_of(dtype, d)
    for kernel in tfa.KERNELS:
        with pytest.raises(exc, match="256|bfloat16"):
            tfa._plan(kernel, dtype, d, None)


@pytest.mark.parametrize("dtype,d,route", [
    (F16, 64, "mma"), (BF16, 200, "mma"), (BF16, 32, "wgmma")])
def test_forced_routes_need_their_instance(dtype, d, route):
    """``route=`` (for measurement) forces a kernel route only where it has
    an instance: mma.sync takes bf16 and float32 up to 128, wgmma 64 to
    256."""
    for kernel in tfa.KERNELS:
        with pytest.raises(ValueError, match="head dims"):
            tfa._plan(kernel, dtype, d, route)
        with pytest.raises(ValueError, match="unknown route"):
            tfa._plan(kernel, dtype, d, "tma")


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """The built library's name hashes the headers the source includes, so
    a change to ``hopper.cuh`` alone rebuilds both wgmma libraries and
    leaves the mma.sync one (which does not include it) as it was."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    names = ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_attention")
    before = {n: _build.library_path(n) for n in names}
    assert str(src / "hopper.cuh") in _build._sources("flash_bwd_wgmma")
    with open(src / "hopper.cuh", "a") as fh:
        fh.write("\n// changed\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["flash_fwd_wgmma"] != before["flash_fwd_wgmma"]
    assert after["flash_bwd_wgmma"] != before["flash_bwd_wgmma"]
    assert after["flash_attention"] == before["flash_attention"]
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in after.values())
