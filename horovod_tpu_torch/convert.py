"""Load the flax transformer's parameters into the port's model.

:func:`params_from_jax` takes the param tree of
:class:`horovod_tpu.models.TransformerLM` as nested dicts of numpy arrays
(``jax.device_get(variables["params"])``) and returns a ``state_dict`` for
:class:`horovod_tpu_torch.models.TransformerLM`. The layouts differ:

- a ``Dense`` kernel (in, out) becomes a ``weight`` (out, in);
- the query/key/value ``DenseGeneral`` kernels (hidden, heads, head_dim)
  and biases (heads, head_dim) flatten to (hidden, hidden) and (hidden,);
- the attention output kernel (heads, head_dim, hidden) flattens to
  (hidden, hidden) and transposes;
- ``Embed.embedding`` is the embedding ``weight``; LayerNorm ``scale`` and
  ``bias`` are ``weight`` and ``bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense(p: Mapping) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"])
    return {"weight": _t(kernel.reshape(-1, kernel.shape[-1]).T),
            "bias": _t(p["bias"])}


def _dense_general_in(p: Mapping) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"])  # (hidden, heads, head_dim)
    return {"weight": _t(kernel.reshape(kernel.shape[0], -1).T),
            "bias": _t(np.asarray(p["bias"]).reshape(-1))}


def _norm(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    put("tok_embed", {"weight": _t(params["tok_embed"]["embedding"])})
    put("pos_embed", {"weight": _t(params["pos_embed"]["embedding"])})
    i = 0
    while f"layer_{i}" in params:
        layer = params[f"layer_{i}"]
        attn = layer["MultiHeadAttention_0"]
        pre = f"layers.{i}"
        put(f"{pre}.ln1", _norm(layer["LayerNorm_0"]))
        for name in ("query", "key", "value"):
            put(f"{pre}.attn.{name}", _dense_general_in(attn[name]))
        put(f"{pre}.attn.out", _dense(attn["out"]))
        put(f"{pre}.ln2", _norm(layer["LayerNorm_1"]))
        put(f"{pre}.mlp_in", _dense(layer["Dense_0"]))
        put(f"{pre}.mlp_out", _dense(layer["Dense_1"]))
        i += 1
    put("final_norm", _norm(params["final_norm"]))
    put("lm_head", _dense(params["lm_head"]))
    return out
