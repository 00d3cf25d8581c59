"""The CUDA path's padding of its inputs to a kernel instance, against the
JAX package.

Flash attention zero-pads head dims 8, 48 and 96 to 32, 64 and 128 and
keeps the scale of the original head dim (12, 136, 200 and 256 in
``test_torch_flash_wide.py``, through ``check_padded_head_dim``); the
LM-head cross-entropy zero-pads hidden sizes 16, 48, 1000 and 12 to 256,
256, 1024 and 256. Here the plain versions of the kernels run on the
padded float32 inputs, on the CPU, and are held to the unpadded plain
results and to the JAX kernels (Pallas in interpret mode) on the same
seeded inputs, with the tolerances of ``test_torch_flash_attention.py``
and ``test_torch_chunked_loss.py``, whose input helpers this file shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import chunked_loss as tcl
from horovod_tpu_torch.ops import flash_attention as tfa
from test_torch_chunked_loss import GRAD_TOL, LOSS_TOL, _data, _jax
from test_torch_flash_attention import TOL, _bhsd, _inputs


def check_padded_head_dim(d, dp, causal):
    """The CUDA path's rewrite of head dim d as the kernel instance dp:
    the plain versions on zero-padded float32 inputs, with the scale of the
    original head dim, give the unpadded results in the first d columns,
    zeros in the rest, and the JAX kernels' results (interpret mode)."""
    q, k, v, do = _inputs(32, d, seed=2)
    assert tfa.kernel_head_dim(d) == dp
    tq, tk, tv, tdo = (torch.from_numpy(_bhsd(a)) for a in (q, k, v, do))
    pq, pk, pv, pdo = (tfa.pad_head_dim(t, dp) for t in (tq, tk, tv, tdo))
    scale = d ** -0.5
    po, plse = tfa.flash_fwd_reference(pq, pk, pv, causal, scale)
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, causal)
    np.testing.assert_allclose(po[..., :d].numpy(), o.numpy(), **TOL)
    assert not po[..., d:].any()
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), **TOL)
    jo, jlse = jfa._fwd_bhsd(*(jnp.asarray(_bhsd(a)) for a in (q, k, v)),
                             causal, 16, 16, True)
    np.testing.assert_allclose(po[..., :d].numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse)[..., 0], **TOL)

    delta = tfa.attention_delta(pdo, po)
    pdq = tfa.flash_dq_reference(pq, pk, pv, plse, delta, pdo, causal, scale)
    pdk, pdv = tfa.flash_dkv_reference(pq, pk, pv, plse, delta, pdo, causal,
                                       scale)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            block_q=16, block_k=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for name, got, j in zip("qkv", (pdq, pdk, pdv), jgrads):
        assert not got[..., d:].any(), f"d{name}"
        np.testing.assert_allclose(got[..., :d].numpy(), _bhsd(np.asarray(j)),
                                   **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 48, 96])
def test_padded_head_dims_match_jax(d, causal):
    """Head dims 8, 48 and 96 padded to the instances 32, 64 and 128."""
    check_padded_head_dim(d, {8: 32, 48: 64, 96: 128}[d], causal)


@pytest.mark.parametrize("h", [16, 48, 1000, 12])
def test_padded_hidden_matches_jax(h):
    """The CUDA path's rewrite of hidden size H as the next kernel
    instance: the plain versions on zero-padded float32 operands give the
    unpadded loss and lse, and dx and dW in the first H columns (zeros in
    the rest), which match the JAX kernels (interpret mode)."""
    hs, w, b, lab, cot = _data((15,), 70, hdim=h, seed=3)
    want = _jax("fused", hs, w, b, lab, cot, 8, 32)
    hp = tcl.kernel_hidden(h)
    x = torch.from_numpy(hs)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    tb, tlab, g = (torch.from_numpy(a) for a in (b, lab, cot))
    px, pw = tcl.pad_hidden(x, hp), tcl.pad_hidden(wt, hp)
    loss, lse = tcl.ce_fwd_reference(px, pw, tb, tlab)
    dx = tcl.ce_dx_reference(px, pw, tb, tlab, lse, g)
    dw, db = tcl.ce_dw_reference(px, pw, tb, tlab, lse, g)
    uloss, ulse = tcl.ce_fwd_reference(x, wt, tb, tlab)
    np.testing.assert_allclose(loss.numpy(), uloss.numpy(), **LOSS_TOL)
    np.testing.assert_allclose(lse.numpy(), ulse.numpy(), **LOSS_TOL)
    np.testing.assert_allclose(loss.numpy(), want[0], **LOSS_TOL)
    assert not dx[:, h:].any() and not dw[:, h:].any()
    for name, got, ref in (("dx", dx[:, :h], want[1]),
                           ("dW", dw[:, :h], want[2]), ("db", db, want[3])):
        np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL, err_msg=name)
