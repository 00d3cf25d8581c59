"""LM-head cross-entropy of the PyTorch port against the JAX package.

The port's ``fused_softmax_cross_entropy`` (on the CPU: the plain versions
of its CUDA kernels) and ``chunked_softmax_cross_entropy`` run on the same
seeded inputs as JAX's ``fused_softmax_cross_entropy`` (Pallas in
interpret mode, as tests/test_chunked_loss.py runs it) and JAX's
``chunked_softmax_cross_entropy``. The head is made in JAX's (H, V) layout
and handed to the port transposed, as ``convert.py`` does. Compared: the
per-token losses, the float32 lse, and dx, dW and db under a non-uniform
cotangent.

Tolerances, those of tests/test_chunked_loss.py: float32 losses and lse at
rtol 1e-5 / atol 1e-6, float32 gradients at rtol 2e-4 / atol 1e-6 (the
frameworks differ only in the order of their float32 sums). With bf16
hidden states the losses keep rtol 1e-5 (both sides accumulate the same
bf16 products in float32) and dx, which comes back in bf16, is held to one
bf16 ulp (rtol 2**-7). The hidden-size padding of the CUDA path (to 256,
512, 768 or 1024) is checked the same way in
``test_torch_kernel_padding.py``, and which inputs the CUDA path takes on
tensor metadata here and in ``test_torch_chunked_loss_routes.py``. The
CUDA kernels themselves are checked against the same plain versions on
the GPU by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import chunked_loss as jcl
from horovod_tpu_torch.ops import chunked_loss as tcl

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)

# name -> (leading shape, vocabulary, block_n, block_v)
CASES = {
    "ragged_vocab": ((3, 5), 70, 8, 32),  # V = 70 on a 32 tile
    "ragged_rows": ((15,), 64, 8, 32),    # 15 tokens on an 8-row tile
}
IMPLS = ("fused", "chunked")


def _data(lead, vocab, hdim=16, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(*lead, hdim).astype(np.float32)
    w = (rng.randn(hdim, vocab) * 0.1).astype(np.float32)  # JAX (H, V)
    b = (rng.randn(vocab) * 0.1).astype(np.float32)
    lab = rng.randint(0, vocab, lead).astype(np.int64)
    cot = np.random.RandomState(seed + 1).rand(*lead).astype(np.float32)
    return h, w, b, lab, cot


def _jax(impl, h, w, b, lab, cot, bn, bv):
    """Losses and (dx, dW in the port's (V, H) layout, db) from JAX."""
    def loss(h, w, b):
        labels = jnp.asarray(lab, jnp.int32)
        if impl == "fused":
            return jcl.fused_softmax_cross_entropy(h, w, b, labels, bn, bv)
        return jcl.chunked_softmax_cross_entropy(h, w, b, labels, bv)

    out, vjp = jax.vjp(loss, jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(cot))
    return (np.asarray(out), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw).T, np.asarray(db), dx.dtype)


def _port(impl, h, w, b, lab, cot, bn, bv):
    """Losses, (dx, dW, db) and dx's dtype from the port."""
    th = torch.from_numpy(np.asarray(h, np.float32))
    if h.dtype != np.float32:
        th = th.to(torch.bfloat16)
    th.requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    labels = torch.from_numpy(lab)
    if impl == "fused":
        out = tcl.fused_softmax_cross_entropy(th, tw, tb, labels,
                                              block_n=bn, block_v=bv)
    else:
        out = tcl.chunked_softmax_cross_entropy(th, tw, tb, labels, chunk=bv)
    out.backward(torch.from_numpy(cot))
    return (out.detach().numpy(), th.grad.float().numpy(), tw.grad.numpy(),
            tb.grad.numpy(), th.grad.dtype)


@functools.lru_cache(maxsize=None)
def _jax_case(impl, case):
    lead, vocab, bn, bv = CASES[case]
    return _jax(impl, *_data(lead, vocab), bn, bv)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ref", IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_losses_match_jax(impl, ref, case):
    lead, vocab, bn, bv = CASES[case]
    got = _port(impl, *_data(lead, vocab), bn, bv)
    np.testing.assert_allclose(got[0], _jax_case(ref, case)[0], **LOSS_TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ref", IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_match_jax(impl, ref, case):
    lead, vocab, bn, bv = CASES[case]
    got = _port(impl, *_data(lead, vocab), bn, bv)
    want = _jax_case(ref, case)
    assert got[4] == torch.float32
    for name, g, w in zip(("dx", "dW", "db"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_lse_matches_jax_kernel(case):
    """The plain forward's float32 lse against the Pallas forward's."""
    lead, vocab, bn, bv = CASES[case]
    h, w, b, lab, _ = _data(lead, vocab)
    h2d, lab1 = h.reshape(-1, h.shape[-1]), lab.reshape(-1)
    _, jlse = jcl._ce_fwd_call(jnp.asarray(h2d), jnp.asarray(w),
                               jnp.asarray(b), jnp.asarray(lab1, jnp.int32),
                               bn, bv, True)
    loss, lse = tcl.ce_fwd_reference(
        torch.from_numpy(h2d), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(b), torch.from_numpy(lab1))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:len(lab1)],
                               **LOSS_TOL)
    assert loss.dtype == lse.dtype == torch.float32


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_hidden(impl):
    """bf16 hidden states: dx comes back in bf16 and agrees with the JAX
    kernels run on the same bf16 inputs."""
    h, w, b, lab, cot = _data((15,), 70)
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16))
    want = _jax("fused", hb, w, b, lab, cot, 8, 32)
    got = _port(impl, hb, w, b, lab, cot, 8, 32)
    assert got[4] == torch.bfloat16 and want[4] == jnp.bfloat16
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **BF16_ULP, err_msg="dx")
    for name, g, w_ in zip(("dW", "db"), got[2:4], want[2:4]):
        np.testing.assert_allclose(g, w_, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
def test_mask_ignored_labels_via_cotangent(impl):
    """The ignore-index convention of the JAX package: clip the ignored
    label into range and weight its loss with 0; that zero cotangent zeroes
    the token's gradient, and the weighted loss equals JAX's."""
    h, w, b, lab, _ = _data((6,), 70)
    raw = lab.copy()
    raw[2] = -100
    keep = (raw >= 0).astype(np.float32)
    clipped = np.clip(raw, 0, None)
    want = _jax("fused", h, w, b, clipped, keep, 8, 32)
    got = _port(impl, h, w, b, clipped, keep, 8, 32)
    np.testing.assert_allclose((got[0] * keep).sum(), (want[0] * keep).sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1][2], 0.0, atol=1e-7)
    assert np.abs(got[1][[0, 1, 3, 4, 5]]).min() > 0
    for name, g, w_ in zip(("dx", "dW", "db"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w_, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
def test_out_of_range_label_gives_lse(impl):
    """An out-of-range label is not detected: its loss is lse - 0 and its
    gradient a pure softmax, as in JAX."""
    h, w, b, lab, cot = _data((6,), 70)
    lab[2] = -100
    want = _jax(impl, h, w, b, lab, cot, 8, 32)
    got = _port(impl, h, w, b, lab, cot, 8, 32)
    _, lse = tcl.ce_fwd_reference(
        torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(b), torch.from_numpy(lab))
    assert got[0][2] == pytest.approx(float(lse[2]), rel=1e-6)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    for name, g, w_ in zip(("dx", "dW", "db"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w_, **GRAD_TOL, err_msg=name)


def _good(n=8, h=256, v=70):
    return dict(x=torch.zeros(n, h, dtype=torch.bfloat16),
                w=torch.zeros(v, h, dtype=torch.bfloat16),
                b=torch.zeros(v), labels=torch.zeros(n, dtype=torch.int64),
                lse=torch.zeros(n), g=torch.zeros(n))


def _misaligned(n, h):
    return torch.zeros(n * h + 1, dtype=torch.bfloat16)[1:].view(n, h)


BAD_INPUTS = {
    # Hidden sizes reach the kernels padded to an instance (kernel_operands);
    # above 1024 none takes them.
    "hidden_48": (ValueError, dict(
        x=torch.zeros(8, 1032, dtype=torch.bfloat16),
        w=torch.zeros(70, 1032, dtype=torch.bfloat16))),
    # Float32 hidden states reach the kernels rounded to bf16; float16 has
    # no route.
    "x_float32": (TypeError, dict(x=torch.zeros(8, 256,
                                                dtype=torch.float16))),
    "w_float32": (TypeError, dict(w=torch.zeros(70, 256))),
    "bias_bf16": (TypeError, dict(b=torch.zeros(70, dtype=torch.bfloat16))),
    "labels_int32": (TypeError, dict(labels=torch.zeros(8,
                                                        dtype=torch.int32))),
    "w_transposed": (ValueError, dict(w=torch.zeros(
        256, 70, dtype=torch.bfloat16).t())),
    "x_misaligned": (ValueError, dict(x=_misaligned(8, 256))),
    "lse_shape": (ValueError, dict(lse=torch.zeros(9))),
    "no_tokens": (ValueError, dict(x=torch.zeros(0, 256,
                                                 dtype=torch.bfloat16))),
    "x_3d": (ValueError, dict(x=torch.zeros(2, 4, 256,
                                            dtype=torch.bfloat16))),
}


@pytest.mark.parametrize("h", [256, 512, 768, 1024])
def test_kernel_input_checks_accept_instances(h):
    t = _good(h=h)
    assert tcl.check_kernel_inputs("ce_fwd", t["x"], t["w"], t["b"],
                                   t["labels"]) == (8, h, 70)


def test_kernel_input_checks_accept_good_inputs():
    t = _good()
    assert tcl.check_kernel_inputs("ce_dx", t["x"], t["w"], t["b"],
                                   t["labels"], t["lse"], t["g"]) == (8, 256,
                                                                      70)


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_kernel_input_checks_raise(bad):
    """What the CUDA wrappers refuse, checked on tensor metadata (no GPU
    needed): the wrappers run these checks before every launch."""
    exc, change = BAD_INPUTS[bad]
    t = {**_good(), **change}
    with pytest.raises(exc):
        tcl.check_kernel_inputs("ce_dx", t["x"], t["w"], t["b"],
                                t["labels"], t["lse"], t["g"])


def test_cpu_call_launches_no_kernel():
    tcl.reset_launch_counts()
    h, w, b, lab, cot = _data((15,), 70)
    _port("fused", h, w, b, lab, cot, 8, 32)
    assert tcl.LAUNCHES == {"ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


@pytest.mark.parametrize("kw", [dict(block_n=0), dict(block_v=-1)])
def test_fused_rejects_bad_blocks(kw):
    h, w, b, lab, _ = _data((4,), 70)
    with pytest.raises(ValueError):
        tcl.fused_softmax_cross_entropy(
            torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T)),
            torch.from_numpy(b), torch.from_numpy(lab), **kw)


@pytest.mark.parametrize("n,v,sms", [(4096, 30522, 132), (1000, 30522, 132),
                                     (64, 70, 132), (8, 1, 1)])
def test_vocab_splits_cover_the_vocabulary(n, v, sms):
    splits, per = tcl.vocab_splits(n, v, sms)
    tiles = -(-v // 32)
    assert 1 <= splits <= 16 and per >= 1
    assert splits * per >= tiles > (splits - 1) * per
    if (n, v, sms) == (4096, 30522, 132):
        assert (splits, per) == (2, 477)  # 64 token tiles x 2 = 128 CTAs


def test_failed_parallel_build_raises(monkeypatch, tmp_path):
    """A build that fails inside ``load_all`` raises KernelBuildError and
    loads nothing: no kernel library falls back to anything."""
    from horovod_tpu_torch.ops import _build

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError):
        _build.load_all(["flash_attention", "chunked_loss"])
    assert _build._libs == {}
