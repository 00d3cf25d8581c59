"""Which flash-attention kernel route and instance the port's wrappers
pick, and which inputs they refuse.

All of it is decided in Python from tensor metadata before any launch, so
it is checked here on CPU tensors: the forward route (wgmma or mma.sync)
for each dtype and head dim, the head dim of the kernel instance an input
is padded to, the cast to bf16, and the errors for head dims and dtypes no
instance takes. The backward's routes, float16 and head dims above 128
are checked in ``test_torch_flash_bwd_routes.py``. The numerics of the
padded path are checked against the JAX package in
``test_torch_kernel_padding.py`` and ``test_torch_flash_wide.py``.
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_input_checks_accept_instances(d):
    t = torch.zeros(4, 64, d, dtype=torch.bfloat16)
    assert tfa._check("t", operands=(t, t)) == (4, 64, d)


# (dtype, head dim) -> (forward route, head dim of the kernel instance)
ROUTES = {
    "bf16_64": (torch.bfloat16, 64, "wgmma", 64),
    "bf16_128": (torch.bfloat16, 128, "wgmma", 128),
    "bf16_48": (torch.bfloat16, 48, "wgmma", 64),
    "bf16_96": (torch.bfloat16, 96, "wgmma", 128),
    "bf16_32": (torch.bfloat16, 32, "mma", 32),
    "bf16_8": (torch.bfloat16, 8, "mma", 32),
    "bf16_24": (torch.bfloat16, 24, "mma", 32),
    "f32_64": (torch.float32, 64, "mma", 64),
    "f32_128": (torch.float32, 128, "mma", 128),
    "f32_8": (torch.float32, 8, "mma", 32),
    "f32_120": (torch.float32, 120, "mma", 128),
}


@pytest.mark.parametrize("case", ROUTES)
def test_forward_route_and_instance(case):
    """Which forward kernel takes which inputs, and the instance they are
    padded to: bf16 at a padded head dim of 64 or 128 takes the wgmma
    kernel; float32 and head dims up to 32 take the mma.sync kernel."""
    dtype, d, route, dp = ROUTES[case]
    assert tfa.fwd_route(dtype, d) == route
    assert tfa.kernel_head_dim(d) == dp
    q = torch.zeros(2, 16, d, dtype=dtype)
    (qk,) = tfa._to_kernel("t", (q,), dp)
    assert qk.dtype == torch.bfloat16 and qk.shape == (2, 16, dp)
    assert tfa._check("t", operands=(qk,)) == (2, 16, dp)


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.bfloat16, 264, ValueError), (torch.bfloat16, 512, ValueError),
    (torch.bfloat16, 0, ValueError), (torch.float32, 257, ValueError),
    (torch.float64, 64, TypeError)])
def test_inputs_the_cuda_path_still_refuses(dtype, d, exc):
    """Head dims of 0 or above 256, and dtypes other than bf16, float16
    and float32, raise before any launch; the message names the limit."""
    with pytest.raises(exc, match="256|bfloat16"):
        tfa.fwd_route(dtype, d)
    with pytest.raises(exc):
        if exc is ValueError:
            tfa.kernel_head_dim(d)
        else:
            tfa._to_kernel("t", (torch.zeros(2, 16, d, dtype=dtype),), d)
