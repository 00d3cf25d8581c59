"""The port's TransformerLM against the flax original on converted weights.

Tiny config (2 layers, hidden 64, 2 heads, MLP 256, vocab 97, seq 32).
The flax model is initialized, its params are converted by
``horovod_tpu_torch.convert.params_from_jax``, and both models see the
same tokens. Tolerances:

- float32 compute: logits and the loss's gradients at atol 1e-4 (the two
  differ only in the order of their sums);
- bf16 compute: logits at atol 0.05, about 3 bf16 ulps at the logits'
  scale of ~4 (the frameworks round activations to bf16 at different
  points of the stack; the error measured on this input is ~0.03).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import transformer as jtr
from horovod_tpu.ops.flash_attention import flash_attention as jflash
from horovod_tpu_torch.convert import params_from_jax
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops.flash_attention import flash_attention as tflash

TINY = dict(vocab_size=97, num_layers=2, num_heads=2, hidden_dim=64,
            mlp_dim=256, max_len=32)


def _models(dtype, attention, causal=False):
    jcfg = jtr.TransformerConfig(
        **TINY, causal=causal,
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16,
        attention_fn=jflash if attention == "flash" else None)
    tcfg = ttr.TransformerConfig(
        **TINY, causal=causal,
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16,
        attention_fn=tflash if attention == "flash" else None)
    tokens = np.random.RandomState(0).randint(0, 97, (2, 32))
    jmodel = jtr.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    tmodel = ttr.TransformerLM(tcfg)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel, tokens


def _jax_loss(jmodel, params, tokens):
    logits = jmodel.apply({"params": params}, tokens)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.roll(tokens, -1, axis=1)).mean()


def _torch_loss(tmodel, tokens):
    logits = tmodel(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           torch.roll(tokens, -1, dims=1).reshape(-1))


@pytest.mark.parametrize("attention,causal", [("plain", False),
                                              ("flash", False),
                                              ("plain", True)])
def test_f32_logits_and_grads_match_flax(attention, causal):
    jmodel, params, tmodel, tokens = _models("f32", attention, causal)
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens)
    jlogits = jmodel.apply({"params": params}, jtok)
    np.testing.assert_allclose(tmodel(ttok).detach().numpy(),
                               np.asarray(jlogits), atol=1e-4, rtol=0)

    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, jtok))(params)
    tloss = _torch_loss(tmodel, ttok)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    want = params_from_jax(jax.device_get(jgrads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_bf16_logits_match_flax(attention):
    jmodel, params, tmodel, tokens = _models("bf16", attention)
    jlogits = np.asarray(jmodel.apply({"params": params},
                                      jnp.asarray(tokens)))
    tlogits = tmodel(torch.from_numpy(tokens)).detach()
    assert tlogits.dtype == torch.float32  # the lm_head is float32
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=0.05, rtol=0)


def test_init_follows_flax_distributions():
    cfg = ttr.TransformerConfig(vocab_size=512, num_layers=1, num_heads=4,
                                hidden_dim=256, mlp_dim=1024, max_len=64)
    a = ttr.TransformerLM(cfg, generator=torch.Generator().manual_seed(3))
    b = ttr.TransformerLM(cfg, generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name  # same seed, same weights
    w = a.layers[0].mlp_in.weight.detach()  # lecun normal, fan_in 256
    assert abs(float(w.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    bound = 2 * 256 ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= bound
    e = a.tok_embed.weight.detach()  # normal(1/sqrt(features))
    assert abs(float(e.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert float(a.layers[0].mlp_in.bias.abs().max()) == 0.0
    assert torch.equal(a.final_norm.weight, torch.ones(256))


def test_too_long_sequence_and_dropout():
    cfg = ttr.TransformerConfig(**{**TINY, "max_len": 8}, dropout_rate=0.5)
    model = ttr.TransformerLM(cfg)
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros(1, 9, dtype=torch.long))
    drop = ttr.Dropout(0.5)
    x = torch.ones(4096)
    assert drop(x) is x
    with pytest.raises(ValueError, match="Generator"):
        drop(x, deterministic=False)
    y = drop(x, deterministic=False,
             generator=torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.05
