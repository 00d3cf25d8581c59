"""Fused layout, AdamW and DistributedOptimizer of the PyTorch port against
the JAX package (``horovod_tpu.jax.fused`` and ``optax.adamw``).

Same seeded gradients into both; three steps. Tolerance rtol 1e-6 (the
update is the same float32 arithmetic in the same order; only the float32
power in the bias correction may round differently).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.jax import fused as jfused
from horovod_tpu_torch import fused as tfused
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.optimizer import (
    DistributedOptimizer,
    Optimizer,
    adamw,
    apply_updates,
)

# Mixed sizes around the 4096-element threshold, two dtypes.
SHAPES = [((64, 96), np.float32), ((96,), np.float32), ((8, 8), np.float16),
          ((4096,), np.float32), ((10,), np.float16), ((3, 5), np.float32)]


def _tree(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(dt) for s, dt in SHAPES]


def test_layout_pack_unpack_match_jax():
    tree = _tree(0)
    jl = jfused._layout_of(tree, jfused.DEFAULT_THRESHOLD_ELEMS)
    tl = tfused._layout_of([torch.from_numpy(a) for a in tree],
                           tfused.DEFAULT_THRESHOLD_ELEMS)
    assert tfused.DEFAULT_THRESHOLD_ELEMS == jfused.DEFAULT_THRESHOLD_ELEMS
    assert [s is None for s in tl.slots] == [s is None for s in jl.slots]
    assert [s[1] for s in tl.slots if s] == [s[1] for s in jl.slots if s]
    jp = jfused._pack(tree, jl)
    tp = tfused._pack([torch.from_numpy(a) for a in tree], tl)
    want = [jp["buf"][k] for k in jl.group_keys] + jp["big"]
    assert len(tp) == len(want)
    for got, exp in zip(tp, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    for got, exp in zip(tfused._unpack(tp, tl), tree):
        np.testing.assert_array_equal(got.numpy(), exp)


def test_small_grads_join_param_dtype_buffer():
    params = [torch.zeros(8), torch.zeros(5000)]
    layout = tfused._layout_of(params, 4096)
    grads = [torch.ones(8, dtype=torch.bfloat16), torch.ones(5000)]
    packed = tfused._pack(grads, layout, cast_small=True)
    assert packed[0].dtype == torch.float32 and packed[0].shape == (8,)
    assert packed[1] is grads[1]


def _f32(seed, scale=1.0):
    return [(a.astype(np.float32) * scale) for a in _tree(seed)]


@pytest.mark.parametrize("fused", [False, True])
def test_adamw_three_steps_match_optax(fused):
    params = _f32(1)
    grads = [_f32(10 + i, 0.1) for i in range(3)]

    jopt = optax.adamw(1e-4, weight_decay=0.01)
    if fused:
        jopt = jfused.fuse(jopt)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)

    topt = adamw(1e-4, weight_decay=0.01)
    if fused:
        topt = tfused.fuse(topt)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tparams)

    for g in grads:
        jupd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate,
                                   jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = topt.update([torch.from_numpy(x) for x in g], tstate,
                                   tparams)
        apply_updates(tparams, tupd)
        for t, j in zip(tupd, jupd):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-12)
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    jmu = jstate[0].mu
    if fused:  # the port orders the packed list as [buffers..., big...]
        jmu = [jmu["buf"][k] for k in sorted(jmu["buf"])] + jmu["big"]
    assert tstate.count == int(jstate[0].count) == 3
    for t, j in zip(tstate.mu, jmu):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


@pytest.fixture
def world_of_one():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_distributed_optimizer_world_of_one_is_the_inner_update(world_of_one):
    params = [torch.from_numpy(p) for p in _f32(2)]
    grads = [torch.from_numpy(g) for g in _f32(3, 0.1)]
    dopt = DistributedOptimizer(adamw(1e-4, weight_decay=0.01),
                                fused_update=True)
    ref = tfused.fuse(adamw(1e-4, weight_decay=0.01))
    dupd, _ = dopt.update(grads, dopt.init(params), params)
    rupd, _ = ref.update(grads, ref.init(params), params)
    for a, b in zip(dupd, rupd):
        assert torch.equal(a, b)


def test_optimizer_step_reads_grads(world_of_one):
    model = torch.nn.Linear(3, 2)
    opt = Optimizer(DistributedOptimizer(adamw(0.1, weight_decay=0.0)),
                    model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    # First Adam step: every coordinate with a gradient moves by ~lr.
    for b, p in zip(before, model.parameters()):
        np.testing.assert_allclose((b - p).abs().detach().numpy(), 0.1,
                                   rtol=1e-4)
    opt.zero_grad()
    assert all(p.grad is None for p in model.parameters())
    opt.step()  # no gradients: zeros, so only the momentum moves them
    assert opt.state.count == 2


@pytest.mark.parametrize("kwargs", [dict(sharded_update=True),
                                    dict(state_dtype="bf16"),
                                    dict(backward_passes_per_step=2),
                                    dict(compression="int8")])
def test_not_ported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        DistributedOptimizer(adamw(1e-4), **kwargs)


def test_compression_registry_and_casts():
    with pytest.raises(ValueError, match="unknown compression"):
        Compression.resolve("bogus")
    with pytest.raises(ValueError, match="invalid compression"):
        Compression.resolve(object())
    assert Compression.resolve(None) is Compression.none
    x = torch.linspace(-3, 3, 7, dtype=torch.float32)
    for name, wire in (("fp16", torch.float16), ("bf16", torch.bfloat16)):
        comp = Compression.resolve(name)
        c, ctx = comp.compress(x)
        assert c.dtype == wire and ctx == torch.float32
        back = comp.decompress(c, ctx)
        assert back.dtype == torch.float32
        np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-2)
    i = torch.arange(3)
    assert Compression.fp16.compress(i) == (i, None)
    assert Compression.none.compress(x) == (x, None)
