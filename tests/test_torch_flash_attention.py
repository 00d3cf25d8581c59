"""Flash attention of the PyTorch port against the JAX package.

The port's CPU path (the plain PyTorch versions of its CUDA kernels) runs
on the same seeded inputs as the Pallas kernels in interpret mode, in
float32: output, row log-sum-exp, and dq/dk/dv through ``jax.vjp``.
Tolerance: atol = rtol = 1e-5 (float32, the two differ only in the order
of their sums). The head-dim padding of the CUDA path (8 -> 32, 48 -> 64,
96 -> 128) is checked the same way in ``test_torch_kernel_padding.py``
(12, 136, 200, 256 and float16 in ``test_torch_flash_wide.py``), and which
inputs reach which kernel route on tensor metadata in
``test_torch_flash_routes.py`` and ``test_torch_flash_bwd_routes.py``. The CUDA kernels themselves are checked
against the same plain versions on the GPU by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)

# (seq, head_dim, block_q, block_k): multi-block on the JAX side.
CASES = [(64, 32, 16, 16), (48, 16, 8, 16), (32, 8, 16, 8)]


def _inputs(s, d, b=1, h=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _bhsd(a):
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,bq,bk", CASES)
def test_forward_and_lse_match_jax(s, d, bq, bk, causal):
    q, k, v, _ = _inputs(s, d)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=bq, block_k=bk)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              block_q=bq, block_k=bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

    jo, jlse = jfa._fwd_bhsd(*(jnp.asarray(_bhsd(a)) for a in (q, k, v)),
                             causal, bq, bk, True)
    to, tlse = tfa.flash_fwd_reference(
        *(torch.from_numpy(_bhsd(a)) for a in (q, k, v)), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0], **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,bq,bk", CASES)
def test_gradients_match_jax_vjp(s, d, bq, bk, causal):
    q, k, v, do = _inputs(s, d, seed=1)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            block_q=bq, block_k=bk),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk)
    out.backward(torch.from_numpy(do))
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"d{name}")


def test_causal_wrapper_and_plain_backward_agree():
    q, k, v, do = (torch.from_numpy(_bhsd(a)) for a in _inputs(32, 8))
    o, lse = tfa.flash_fwd_reference(q, k, v, True)
    dq, dk, dv = tfa.flash_bwd_reference(q, k, v, o, lse, do, True)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    logits = (qs * 8 ** -0.5) @ ks.transpose(1, 2)
    logits = logits.masked_fill(torch.ones(32, 32).triu(1).bool(), -1e30)
    ref = torch.softmax(logits, -1) @ vs
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), **TOL)
    ref.backward(do)
    for got, want in ((dq, qs.grad), (dk, ks.grad), (dv, vs.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    b4 = lambda t: t.view(1, 2, 32, 8).permute(0, 2, 1, 3)  # noqa: E731
    out = tfa.flash_attention_causal(b4(q), b4(k), b4(v))
    np.testing.assert_allclose(out.permute(0, 2, 1, 3).reshape(2, 32, 8),
                               o.numpy(), **TOL)


def test_bias_and_block_errors_match_jax():
    q = np.zeros((1, 32, 2, 8), np.float32)
    tq = torch.from_numpy(q)
    with pytest.raises(NotImplementedError):
        jfa.flash_attention(q, q, q, bias=q)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(tq, tq, tq, bias=tq)
    with pytest.raises(ValueError):
        jfa.flash_attention(q, q, q, block_q=12)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(tq, tq, tq, block_q=12)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(tq, tq, tq, block_k=10)


def test_kernel_input_checks():
    """What the CUDA wrappers refuse is decided in Python, before any
    launch, so it is checked here on CPU tensors. ``_check`` sees what
    reaches the kernels, after the cast to bf16 (or float16) and the
    padding."""
    ok = torch.zeros(4, 64, 64, dtype=torch.bfloat16)
    assert tfa._check("t", operands=(ok, ok)) == (4, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa._check("t", operands=(ok.float(),))
    with pytest.raises(TypeError, match="one type"):
        tfa._check("t", operands=(ok, ok.half()))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check("t", operands=(torch.zeros(4, 64, 136,
                                              dtype=torch.bfloat16),))
    with pytest.raises(ValueError, match="shape"):
        tfa._check("t", operands=(ok, torch.zeros(4, 32, 64,
                                                  dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="row statistics"):
        tfa._check("t", operands=(ok,),
                   f32=(torch.zeros(4, 64, dtype=torch.float64),))
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check("t", operands=(ok.transpose(1, 2).contiguous()
                                  .transpose(1, 2),))


def test_cpu_path_launches_no_kernel():
    tfa.reset_launch_counts()
    q, k, v, do = (torch.from_numpy(_bhsd(a)) for a in _inputs(32, 8))
    o, lse = tfa.flash_fwd(q, k, v)
    delta = tfa.attention_delta(do, o)
    tfa.flash_dq(q, k, v, lse, delta, do)
    tfa.flash_dkv(q, k, v, lse, delta, do)
    kernels = ("flash_fwd", "flash_dq", "flash_dkv")
    assert tfa.LAUNCHES == {f"{kernel}{route}": 0 for kernel in kernels
                            for route in ("", "_wgmma", "_mma")}
