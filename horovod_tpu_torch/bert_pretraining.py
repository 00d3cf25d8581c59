"""BERT-base data-parallel pretraining step on the GPU.

Port of ``examples/bert_pretraining_benchmark.py``: the ``TransformerLM``
with flash attention (``--flash``, hand-written CUDA kernels), the
cross-entropy of the next token, gradients allreduced by
:func:`horovod_tpu_torch.DistributedOptimizer` and the fused AdamW update
(``adamw(1e-4, weight_decay=0.01)``, small tensors through per-dtype flat
buffers). The loss is the stock ``F.cross_entropy`` over float32 logits,
or with ``--fused-loss`` the LM-head kernels of
:mod:`horovod_tpu_torch.ops.chunked_loss`, which never materialize the
``[tokens, vocab]`` logits. ``--remat`` recomputes each layer in the
backward; ``--dropout`` turns the model's dropout (0.1) on, drawn from a
per-rank generator on the device seeded from ``--seed`` and the rank.
Defaults are BERT-base (L=12, H=768, A=12, MLP 3072, seq 512, vocab 30522)
at 8 sequences per GPU, bf16 compute and float32 parameters. The steps run
in a plain Python loop.

Run (one GPU; one process per GPU with RANK/WORLD_SIZE/LOCAL_RANK/
MASTER_ADDR/MASTER_PORT set for more)::

    python -m horovod_tpu_torch.bert_pretraining --flash --fused-loss

It prints tokens/s per GPU, step time, MFU against the peak of
:mod:`horovod_tpu_torch.utils.hardware` and the loss.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import TransformerConfig, TransformerLM
from horovod_tpu_torch.ops.chunked_loss import fused_softmax_cross_entropy
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.optimizer import Optimizer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="sequences per GPU")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--flash", action="store_true",
                    help="attention through the flash-attention kernels "
                         "(forward + backward) instead of plain attention")
    ap.add_argument("--fused-loss", action="store_true",
                    help="LM-head cross-entropy through the fused kernels: "
                         "never materializes the [tokens, vocab] logits "
                         "(ops/chunked_loss.py)")
    ap.add_argument("--loss-chunk", type=int, default=1024,
                    help="vocabulary tile of --fused-loss (block_v of the "
                         "JAX version; the CUDA kernels choose their own)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward "
                         "(activation memory for FLOPs)")
    ap.add_argument("--dropout", action="store_true",
                    help="train with the model's dropout (0.1) active")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the token batch and the "
                         "dropout masks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def make_config(args: argparse.Namespace) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
        hidden_dim=args.hidden, mlp_dim=4 * args.hidden,
        max_len=args.seq_len, dtype=torch.bfloat16,
        attention_fn=flash_attention if args.flash else None,
        remat=args.remat)


def make_optimizer(model: torch.nn.Module) -> Optimizer:
    """Broadcast rank 0's weights, then bind the distributed fused AdamW
    to the model's parameters."""
    params = list(model.parameters())
    hvd.broadcast_parameters(params, root_rank=0)
    return Optimizer(hvd.DistributedOptimizer(
        hvd.adamw(1e-4, weight_decay=0.01), fused_update=True), params)


def make_tokens(args: argparse.Namespace, device, local_rank: int = 0,
                local_size: int = 1) -> torch.Tensor:
    """This rank's fixed random batch (batch_size, seq_len) of token ids.

    As in the JAX example, one (batch_size * local_size, seq_len) array is
    drawn from ``--seed`` for the host and sharded over its ranks: local
    rank r trains on rows [r * batch_size, (r + 1) * batch_size), so the
    data-parallel ranks see different rows."""
    rng = np.random.RandomState(args.seed)
    tokens = rng.randint(0, args.vocab,
                         size=(args.batch_size * local_size, args.seq_len))
    rows = tokens[local_rank * args.batch_size:
                  (local_rank + 1) * args.batch_size]
    return torch.from_numpy(rows.astype(np.int64)).to(device)


def make_generator(args: argparse.Namespace,
                   device) -> Optional[torch.Generator]:
    """This rank's dropout stream (None without ``--dropout``): seeded from
    ``--seed`` and the rank, so data-parallel replicas draw different masks,
    as the JAX example's ``fold_in(key, rank)``."""
    if not args.dropout:
        return None
    seed = int(np.random.SeedSequence([args.seed, hvd.rank()])
               .generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def loss_options(args: argparse.Namespace, device) -> dict:
    """The keyword arguments of :func:`loss_fn` that ``args`` select."""
    return {"fused_loss": args.fused_loss, "loss_chunk": args.loss_chunk,
            "generator": make_generator(args, device)}


def loss_fn(model: torch.nn.Module, tokens: torch.Tensor,
            fused_loss: bool = False, loss_chunk: int = 1024,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean cross-entropy of the next token (``roll(tokens, -1)``): over the
    float32 logits of ``lm_head``, or with ``fused_loss`` through
    :func:`fused_softmax_cross_entropy` on the pre-head hidden states.
    Dropout is active when a ``generator`` is given."""
    target = torch.roll(tokens, -1, dims=1)
    deterministic = generator is None
    if fused_loss:
        hidden = model(tokens, deterministic=deterministic,
                       return_hidden=True, generator=generator)
        head = model.lm_head
        return fused_softmax_cross_entropy(
            hidden, head.weight, head.bias, target, block_v=loss_chunk).mean()
    logits = model(tokens, deterministic=deterministic, generator=generator)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           target.reshape(-1))


def train_step(model: torch.nn.Module, opt: Optimizer,
               tokens: torch.Tensor, **options) -> torch.Tensor:
    """Forward, backward, allreduce and update; returns the loss averaged
    over ranks (a device tensor: reading it waits for the step).
    ``options`` are :func:`loss_fn`'s."""
    opt.zero_grad()
    loss = loss_fn(model, tokens, **options)
    loss.backward()
    opt.step()
    return hvd.allreduce(loss.detach())


def flops_per_step(cfg: TransformerConfig, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 3x the forward's matmuls (the
    backward does two products per forward product); recomputation (inside
    the flash and fused-loss backward, or of ``--remat``) is not counted."""
    h, layers = cfg.hidden_dim, cfg.num_layers
    tokens = batch * seq
    dense = layers * (4 * h * h + 2 * h * cfg.mlp_dim) + h * cfg.vocab_size
    attention = layers * 4 * batch * seq * seq * h  # QK^T and PV
    return 3.0 * (2.0 * tokens * dense + attention)


def build(args: argparse.Namespace):
    """World, model, optimizer and batch for ``args`` on ``args.device``."""
    hvd.init(device=args.device)
    device = hvd.device()
    model = TransformerLM(make_config(args),
                          generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    tokens = make_tokens(args, device, hvd.local_rank(), hvd.local_size())
    return model, make_optimizer(model), tokens


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    model, opt, tokens = build(args)
    device = hvd.device()
    options = loss_options(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"# params: {n_params / 1e6:.1f}M, {hvd.size()} rank(s) on "
          f"{device.type}")
    for _ in range(args.warmup):
        train_step(model, opt, tokens, **options)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = train_step(model, opt, tokens, **options)
    loss = float(loss)
    _sync(device)
    step_time = (time.perf_counter() - t0) / max(1, args.steps)
    tok_per_s = args.batch_size * args.seq_len / step_time
    mfu = float("nan")
    if device.type == "cuda":
        from horovod_tpu_torch.utils.hardware import device_peak

        peak = device_peak(device)
        if peak is not None:
            mfu = flops_per_step(model.cfg, args.batch_size,
                                 args.seq_len) / step_time / peak.bf16_flops
    print(f"tokens/sec/gpu: {tok_per_s:.0f}  step_ms: {step_time * 1e3:.2f}"
          f"  mfu: {mfu:.3f}  loss={loss:.5f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
