"""Transformer encoder/LM: BERT-base, the data-parallel training path.

Counterpart of :mod:`horovod_tpu.models.transformer`, with the numerics
of the flax original: float32 parameters, bf16 compute (each dense layer
casts its input and weights to the compute dtype), layer norms with
epsilon 1e-6 that take their statistics in float32, the tanh GELU, and an
untied float32 LM head. ``TransformerConfig.remat`` recomputes each layer
in the backward (``torch.utils.checkpoint``), trading FLOPs for activation
memory as flax's ``nn.remat`` does. Attention is pluggable through
``TransformerConfig.attention_fn`` (signature ``(q, k, v, bias) -> out``
on (batch, seq, heads, head_dim)), so
:func:`horovod_tpu_torch.ops.flash_attention.flash_attention` drops in.

Initialization follows flax's distributions (lecun-normal kernels, zero
biases, unit layer-norm scales, normal(1/sqrt(features)) embeddings),
drawn from an explicit ``torch.Generator``; the same seed does not give
flax's numbers (load those with :mod:`horovod_tpu_torch.convert`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

AttentionFn = Callable[..., torch.Tensor]


def dot_product_attention(q, k, v, bias=None):
    """Plain softmax attention, logits and softmax in float32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q, k, v, bias=None):
    """Causal-masked attention for LM training."""
    qlen, klen = q.shape[1], k.shape[1]
    mask = torch.ones((qlen, klen), dtype=torch.bool, device=q.device).tril()
    causal_bias = torch.where(mask, 0.0, -1e9)[None, None]
    if bias is not None:
        causal_bias = causal_bias + bias
    return dot_product_attention(q, k, v, causal_bias)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522  # BERT wordpiece vocab
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 768
    mlp_dim: int = 3072
    max_len: int = 512
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    causal: bool = False
    attention_fn: Optional[AttentionFn] = None
    remat: bool = False  # checkpoint each layer: FLOPs for memory

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


def _lecun_normal(shape, fan_in: int, generator: torch.Generator):
    """flax's lecun_normal: a normal truncated to +-2 standard deviations,
    rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator) * (1.0 - 2.0 * lo) + lo
    return torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)


class Dense(nn.Module):
    """``y = x W^T + b`` with float32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_lecun_normal(
            (out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax's LayerNorm: float32 statistics (variance as E[x^2] - E[x]^2,
    clipped at 0), epsilon 1e-6, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


class Embed(nn.Module):
    """Embedding table in float32, looked up and cast to ``dtype``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.randn((num_embeddings, features), generator=generator)
            / math.sqrt(features))

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.dtype)


class Dropout(nn.Module):
    """Inverted dropout drawing its mask from an explicit generator;
    identity when ``deterministic``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout needs an explicit torch.Generator")
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.query = Dense(h, h, cfg.dtype, generator)
        self.key = Dense(h, h, cfg.dtype, generator)
        self.value = Dense(h, h, cfg.dtype, generator)
        self.out = Dense(h, h, cfg.dtype, generator)

    def forward(self, x, mask_bias=None):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.num_heads, cfg.head_dim)
        q = self.query(x).view(heads)
        k = self.key(x).view(heads)
        v = self.value(x).view(heads)
        attn = cfg.attention_fn or (
            causal_attention if cfg.causal else dot_product_attention)
        out = attn(q, k, v, mask_bias)
        return self.out(out.reshape(b, s, cfg.hidden_dim))


class EncoderLayer(nn.Module):
    """Pre-norm encoder block: attention and MLP, each with a residual."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_dim, cfg.dtype)
        self.attn = MultiHeadAttention(cfg, generator)
        self.ln2 = LayerNorm(cfg.hidden_dim, cfg.dtype)
        self.mlp_in = Dense(cfg.hidden_dim, cfg.mlp_dim, cfg.dtype, generator)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.hidden_dim, cfg.dtype,
                             generator)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, mask_bias=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = self.attn(self.ln1(x), mask_bias)
        x = x + self.dropout(h, deterministic, generator)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        h = self.mlp_out(h)
        return x + self.dropout(h, deterministic, generator)


def _checkpointed(layer: EncoderLayer, x, deterministic: bool,
                  generator: Optional[torch.Generator]):
    """``layer(x)`` under ``torch.utils.checkpoint``. The checkpoint
    restores the global RNG for the recompute but not an explicit
    generator, so the recompute rewinds ``generator`` to where this layer's
    forward found it (the same dropout masks) and then puts it back where
    the stream had got to."""
    start = None
    if generator is not None and not deterministic:
        start = generator.get_state()
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1 or start is None:
            return layer(x, None, deterministic, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(x, None, deterministic, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class TransformerLM(nn.Module):
    """Token-in, logits-out transformer (pre-norm). With ``cfg.causal`` it
    is a GPT-style LM; without, a BERT-style masked-LM encoder."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.hidden_dim, cfg.dtype,
                               generator)
        self.pos_embed = Embed(cfg.max_len, cfg.hidden_dim, cfg.dtype,
                               generator)
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg, generator) for _ in range(cfg.num_layers)])
        self.final_norm = LayerNorm(cfg.hidden_dim, cfg.dtype)
        # Untied output head, float32 logits.
        self.lm_head = Dense(cfg.hidden_dim, cfg.vocab_size, torch.float32,
                             generator)

    def forward(self, tokens, deterministic: bool = True,
                return_hidden: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        seq = tokens.shape[-1]
        if seq > cfg.max_len:
            raise ValueError(
                f"sequence length {seq} exceeds max_len {cfg.max_len}")
        x = self.tok_embed(tokens)
        x = x + self.pos_embed(torch.arange(seq, device=tokens.device))[None]
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = _checkpointed(layer, x, deterministic, generator)
            else:
                x = layer(x, None, deterministic, generator)
        x = self.final_norm(x)
        if return_hidden:
            # Pre-head hidden states, for heads that consume the lm_head
            # weights directly without materializing [.., vocab] logits.
            return x
        return self.lm_head(x)


def BertBase(**overrides) -> TransformerLM:
    return TransformerLM(TransformerConfig(**overrides))
