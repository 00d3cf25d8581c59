"""Which operands the port's LM-head cross-entropy wrappers hand their
CUDA kernels, and which inputs they refuse.

All of it is decided in Python from tensor metadata before any launch, so
it is checked here on CPU tensors: the hidden size of the kernel instance
x and the head are zero-padded to, the rounding to bf16, the errors for
hidden sizes and dtypes no instance takes, and the forward's token rows
per CTA that the vocabulary split is chosen for. The numerics of the
padded path are checked against the JAX package in
``test_torch_kernel_padding.py``.
"""

import pytest
import torch

from horovod_tpu_torch.ops import chunked_loss as tcl


def _good(n=8, h=256, v=70):
    return dict(x=torch.zeros(n, h, dtype=torch.bfloat16),
                w=torch.zeros(v, h, dtype=torch.bfloat16),
                b=torch.zeros(v), labels=torch.zeros(n, dtype=torch.int64),
                lse=torch.zeros(n), g=torch.zeros(n))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hp", [(16, 256), (48, 256), (256, 256),
                                  (264, 512), (768, 768), (1000, 1024),
                                  (1024, 1024)])
def test_kernel_operands_pad_and_round(h, hp, dtype):
    """What the CUDA path hands the kernels: x and the head in bf16,
    zero-padded to the next instance; check_kernel_inputs accepts it."""
    x = torch.randn(8, h).to(dtype)
    w = torch.randn(70, h)
    xk, wk = tcl.kernel_operands(x, w)
    assert tcl.kernel_hidden(h) == hp
    assert xk.dtype == wk.dtype == torch.bfloat16
    assert xk.shape == (8, hp) and wk.shape == (70, hp)
    assert torch.equal(xk[:, :h], x.to(torch.bfloat16))
    assert torch.equal(wk[:, :h], w.to(torch.bfloat16))
    assert not xk[:, h:].any() and not wk[:, h:].any()
    t = _good(h=hp)
    assert tcl.check_kernel_inputs("ce_dx", xk, wk, t["b"], t["labels"],
                                   t["lse"], t["g"]) == (8, hp, 70)


@pytest.mark.parametrize("h,dtype,exc", [
    (1032, torch.bfloat16, ValueError), (1030, torch.bfloat16, ValueError),
    (2048, torch.float32, ValueError), (256, torch.float16, TypeError),
    (256, torch.int32, TypeError)])
def test_inputs_the_cuda_path_still_refuses(h, dtype, exc):
    """Hidden sizes above 1024, and hidden states other than bf16 or
    float32, raise before any launch; the message names the limit."""
    with pytest.raises(exc, match="1024|bfloat16"):
        tcl.kernel_operands(torch.zeros(8, h, dtype=dtype),
                            torch.zeros(70, h))


@pytest.mark.parametrize("h,rows", [(256, 64), (768, 64), (1024, 32)])
def test_forward_rows_per_instance(h, rows):
    """The forward's token rows per CTA (csrc/chunked_loss.cu fwd_rows),
    which the vocabulary split count is chosen for."""
    assert tcl.fwd_rows(h) == rows
    splits, per = tcl.vocab_splits(4096, 30522, 132, rows)
    assert splits * per >= -(-30522 // 32) > (splits - 1) * per
