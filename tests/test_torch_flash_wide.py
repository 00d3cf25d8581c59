"""Flash attention at the head dims and dtype the CUDA path gained, against
the JAX package.

Head dims 12, 136, 200 and 256 reach the kernels zero-padded to the
instances 32, 256, 256 and 256 (256 itself unpadded): here the port's
plain versions of the kernels run on the padded float32 inputs, on the
CPU, and are held to the unpadded plain results and to the JAX kernels
(Pallas in interpret mode) on the same seeded inputs, at atol = rtol =
1e-5 (float32; the two differ only in the order of their sums), through
``check_padded_head_dim`` of ``test_torch_kernel_padding.py``.

Float16 inputs reach the wgmma kernels as float16. The port's attention
on float16 CPU tensors (the plain versions: float32 arithmetic on the
float16 inputs, outputs rounded to float16) is held to JAX's attention on
the same float16 inputs (interpret mode, which also computes in float32
and rounds its outputs to float16): output and dq/dk/dv to 2 float16 ulps
of the largest magnitude plus 2 ulps relative (each side rounds once; the
backward's inputs carry one rounding of the output, through delta).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import _inputs
from test_torch_kernel_padding import check_padded_head_dim

F16_ULP = 2.0 ** -10


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,dp", [(12, 32), (136, 256), (200, 256),
                                  (256, 256)])
def test_wide_and_unaligned_head_dims_match_jax(d, dp, causal):
    check_padded_head_dim(d, dp, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_float16_matches_jax(causal):
    """Float16 at head dim 64 (the wgmma route computes it in float16):
    output and gradients of the port's attention against JAX's."""
    q, k, v, do = (a.astype(np.float16) for a in _inputs(48, 64, seed=3))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    jout, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            block_q=16, block_k=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for name, got, want in (("o", out, jout), ("dq", tq.grad, jgrads[0]),
                            ("dk", tk.grad, jgrads[1]),
                            ("dv", tv.grad, jgrads[2])):
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            got.detach().float().numpy(), want, rtol=2 * F16_ULP,
            atol=2 * F16_ULP * np.abs(want).max(), err_msg=name)
