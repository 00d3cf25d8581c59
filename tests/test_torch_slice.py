"""The whole slices: two BERT training steps of the PyTorch port against
the JAX package, with the stock loss (slice 1) and with the fused LM-head
loss (slice 2), the ``--remat`` and ``--dropout`` options, and the port's
independence from JAX.

Tiny config (2 layers, hidden 64, 2 heads, MLP 256, vocab 97, seq 32),
float32 compute, flash attention on both sides (Pallas in interpret mode
for JAX, the plain versions of the CUDA kernels for the port), params
converted from the flax init. The JAX step is the example's
``value_and_grad`` + ``fuse(optax.adamw(1e-4, weight_decay=0.01))``, which
is what ``DistributedOptimizer(..., fused_update=True)`` runs in a world
of one; the port's is ``bert_pretraining.train_step``. With the fused loss
both sides take the pre-head hidden states (``return_hidden``) into
``fused_softmax_cross_entropy`` (Pallas in interpret mode for JAX) with a
32-column vocabulary tile. Tolerances: loss
rtol 1e-5, step-1 gradients atol 1e-4, parameters after two steps atol
2e-6 (2% of one lr=1e-4 Adam step: where a gradient is ~1e-8, eps-sized,
the frameworks' float32 rounding moves its update by that much). The key
biases are the exception: their gradient is zero in exact arithmetic, so
Adam turns each side's rounding noise into +-lr steps, and only that
bound is checked.
"""

import argparse
import ast
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.jax as hvd_jax
import horovod_tpu_torch as hvd
from horovod_tpu.jax.fused import fuse
from horovod_tpu.models import transformer as jtr
from horovod_tpu.ops.chunked_loss import fused_softmax_cross_entropy as jfused
from horovod_tpu.ops.flash_attention import flash_attention as jflash
from horovod_tpu_torch import bert_pretraining as bp
from horovod_tpu_torch.convert import params_from_jax
from horovod_tpu_torch.models import transformer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=97, num_layers=2, num_heads=2, hidden_dim=64,
            mlp_dim=256, max_len=32)


@pytest.fixture
def world_of_one():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _two_steps_match_jax(fused_loss):
    tokens = np.random.RandomState(0).randint(0, 97, (2, 32))
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(
        **TINY, dtype=jnp.float32, attention_fn=jflash))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    jopt = fuse(optax.adamw(1e-4, weight_decay=0.01))
    jstate = jopt.init(params)

    @jax.jit
    def jstep(params, state, toks):
        def loss_fn(p):
            target = jnp.roll(toks, -1, axis=1)
            if fused_loss:
                hidden = jmodel.apply({"params": p}, toks, return_hidden=True)
                head = p["lm_head"]
                return jfused(hidden, head["kernel"], head["bias"], target,
                              block_v=32).mean()
            logits = jmodel.apply({"params": p}, toks)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, target).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, upd), state, loss, grads

    tmodel = ttr.TransformerLM(ttr.TransformerConfig(
        **TINY, dtype=torch.float32, attention_fn=bp.flash_attention))
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    opt = bp.make_optimizer(tmodel)
    ttok = torch.from_numpy(tokens)

    for step in range(2):
        params, jstate, jloss, jgrads = jstep(params, jstate,
                                              jnp.asarray(tokens))
        tloss = bp.train_step(tmodel, opt, ttok, fused_loss=fused_loss,
                              loss_chunk=32)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        if step == 0:
            want = params_from_jax(jax.device_get(jgrads))
            first = {}
            for name, p in tmodel.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(),
                                           want[name].numpy(), atol=1e-4,
                                           rtol=0, err_msg=name)
                first[name] = np.minimum(np.abs(p.grad.numpy()),
                                         np.abs(want[name].numpy()))
    want = params_from_jax(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        if name.endswith("attn.key.bias"):
            # Softmax ignores a shift shared by all keys, so this gradient
            # is 0 up to rounding noise, which Adam scales to +-lr per
            # step on either side: only the bound is common.
            assert float(p.detach().abs().max()) <= 2 * 1e-4 * (1 + 1e-3)
            continue
        got, ref = p.detach().numpy(), want[name].numpy()
        if fused_loss:
            # Adam's first update is lr * g / (|g| + eps), eps = 1e-8. Where
            # the first gradient is itself eps-sized (|g| < 1e-6 on either
            # side), each side's float32 rounding of g becomes a different
            # fraction of lr, as for the key biases, and only the bound of
            # two steps of at most lr each is common. The fused loss sums
            # the head's gradient in another order than the logits path
            # and moves such elements (layers.0.mlp_out.weight[53, 89]:
            # first gradients -6.05e-8 vs -4.11e-8, parameters 5.4e-6
            # apart); their first gradients are held to atol 1e-4 above.
            eps_sized = first[name] < 1e-6
            assert np.abs(got - ref)[eps_sized].max(initial=0.0) <= (
                4 * 1e-4 * (1 + 1e-3)), name
            got, ref = got[~eps_sized], ref[~eps_sized]
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0, err_msg=name)


def test_two_train_steps_match_jax(world_of_one):
    _two_steps_match_jax(fused_loss=False)


def test_two_fused_loss_train_steps_match_jax(world_of_one):
    _two_steps_match_jax(fused_loss=True)


def test_entry_point_runs_on_cpu(world_of_one, capsys):
    hvd.shutdown()  # main() brings the world up itself
    bp.main(["--device", "cpu", "--layers", "1", "--hidden", "32",
             "--heads", "2", "--seq-len", "16", "--vocab", "50",
             "--batch-size", "2", "--steps", "2", "--warmup", "1",
             "--flash"])
    out = capsys.readouterr().out
    assert "tokens/sec/gpu:" in out and "loss=" in out


def test_entry_point_runs_fused_loss_on_cpu(world_of_one, capsys):
    hvd.shutdown()
    bp.main(["--device", "cpu", "--layers", "1", "--hidden", "32",
             "--heads", "2", "--seq-len", "16", "--vocab", "50",
             "--batch-size", "2", "--steps", "2", "--warmup", "1",
             "--flash", "--fused-loss", "--loss-chunk", "16", "--remat",
             "--dropout"])
    out = capsys.readouterr().out
    assert "tokens/sec/gpu:" in out and "loss=" in out


def _tiny_pair(remat):
    """Two float32 tiny models with the same weights, without and with
    ``remat`` (or both without)."""
    cfg = ttr.TransformerConfig(**TINY, dtype=torch.float32,
                                attention_fn=bp.flash_attention)
    base = ttr.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    other = ttr.TransformerLM(dataclasses.replace(cfg, remat=remat))
    other.load_state_dict(base.state_dict())
    return base, other


def _loss_and_grads(model, tokens, seed=None, **options):
    generator = None
    if seed is not None:
        generator = torch.Generator().manual_seed(seed)
    model.zero_grad(set_to_none=True)
    loss = bp.loss_fn(model, tokens, generator=generator, **options)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("fused_loss", [False, True])
def test_remat_is_bitwise_equal(fused_loss):
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 97, (2, 32)))
    base, remat = _tiny_pair(remat=True)
    opts = dict(fused_loss=fused_loss, loss_chunk=32)
    loss0, g0 = _loss_and_grads(base, tokens, **opts)
    loss1, g1 = _loss_and_grads(remat, tokens, **opts)
    assert torch.equal(loss0, loss1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name


def test_remat_with_dropout_replays_the_masks():
    """The recompute rewinds the explicit generator: --remat --dropout has
    the same gradients as --dropout alone from the same seed, and leaves
    the generator where a plain step leaves it."""
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 97, (2, 32)))
    base, remat = _tiny_pair(remat=True)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    grads = []
    for model, gen in zip((base, remat), gens):
        model.zero_grad(set_to_none=True)
        loss = bp.loss_fn(model, tokens, generator=gen)
        loss.backward()
        grads.append((loss.detach(),
                      {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_dropout_changes_the_loss_and_is_seeded(world_of_one):
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 97, (2, 32)))
    base, same = _tiny_pair(remat=False)
    plain, _ = _loss_and_grads(base, tokens)
    first, _ = _loss_and_grads(base, tokens, seed=3)
    again, _ = _loss_and_grads(same, tokens, seed=3)
    other, _ = _loss_and_grads(same, tokens, seed=4)
    assert not torch.equal(first, plain)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
    # The entry point's stream: from --seed, and different on each rank.
    args = bp.parse_args(["--dropout", "--seed", "3", "--device", "cpu"])
    draw = lambda: torch.rand(4, generator=bp.make_generator(args, "cpu"))  # noqa: E731
    assert torch.equal(draw(), draw())
    assert bp.make_generator(bp.parse_args(["--device", "cpu"]), "cpu") is None
    rank0 = draw()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bp.hvd, "rank", lambda: 1)
        assert not torch.equal(draw(), rank0)


def test_bert_base_config_and_flops():
    args = bp.parse_args(["--flash"])
    cfg = bp.make_config(args)
    assert (cfg.num_layers, cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim,
            cfg.max_len, cfg.vocab_size) == (12, 768, 12, 3072, 512, 30522)
    assert cfg.dtype == torch.bfloat16 and cfg.attention_fn is not None
    assert args.batch_size == 8
    # 6 * params * tokens for the dense part, plus the attention products.
    h, layers, tok = 768, 12, 8 * 512
    dense = layers * 12 * h * h + h * 30522
    want = 6 * dense * tok + 3 * 4 * 8 * 512 * 512 * h * layers
    assert bp.flops_per_step(cfg, 8, 512) == pytest.approx(want)


def test_tokens_are_seeded():
    args = argparse.Namespace(seed=3, vocab=50, batch_size=2, seq_len=8)
    a = bp.make_tokens(args, "cpu")
    assert torch.equal(a, bp.make_tokens(args, "cpu"))
    assert a.shape == (2, 8) and int(a.max()) < 50


def test_tokens_are_split_by_local_rank():
    """Local rank r of n takes rows [r * b, (r + 1) * b) of the seeded
    (b * n, seq) array, as the JAX example shards it over local devices;
    local rank 0 of 1 keeps the world-of-one batch."""
    args = argparse.Namespace(seed=3, vocab=50, batch_size=2, seq_len=8)
    whole = np.random.RandomState(3).randint(0, 50, (6, 8))
    for rank in range(3):
        got = bp.make_tokens(args, "cpu", local_rank=rank, local_size=3)
        np.testing.assert_array_equal(got.numpy(),
                                      whole[2 * rank:2 * rank + 2])
    np.testing.assert_array_equal(bp.make_tokens(args, "cpu").numpy(),
                                  np.random.RandomState(3).randint(
                                      0, 50, (2, 8)))


# ---------------------------------------------------------------------------
# Data parallelism at world size 2: each rank trains on its own rows.
# ---------------------------------------------------------------------------

TWO_RANK_WORKER = r"""
import argparse, json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import bert_pretraining as bp
from horovod_tpu_torch.models import transformer as ttr

work = sys.argv[1]
tiny = json.loads(sys.argv[2])
hvd.init(device="cpu")
model = ttr.TransformerLM(ttr.TransformerConfig(
    **tiny, dtype=torch.float32, attention_fn=bp.flash_attention))
state = np.load(work + "/init.npz")
model.load_state_dict({k: torch.from_numpy(state[k]) for k in state.files})
opt = bp.make_optimizer(model)
args = argparse.Namespace(seed=0, vocab=tiny["vocab_size"], batch_size=1,
                          seq_len=tiny["max_len"])
tokens = bp.make_tokens(args, "cpu", hvd.local_rank(), hvd.local_size())
losses = [float(bp.train_step(model, opt, tokens)) for _ in range(2)]
np.savez(f"{work}/rank{hvd.rank()}.npz", tokens=tokens.numpy(),
         **{n: p.detach().numpy() for n, p in model.named_parameters()})
print("RESULT " + json.dumps({"rank": hvd.rank(), "losses": losses}),
      flush=True)
hvd.shutdown()
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _jax_two_rank_reference(tokens):
    """Two steps of the JAX example's data-parallel step in a world of two:
    ``DistributedOptimizer(adamw, fused_update=True)`` under ``hvd.jit``,
    the (2, seq) batch sharded one row per rank (``P(HVD_AXIS)``), the loss
    averaged over ranks. Returns the initial and final params and the two
    losses."""
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(
        **TINY, dtype=jnp.float32, attention_fn=jflash))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(tokens[:1]))["params"]
    init = jax.device_get(params)
    # The suite's 8-device JAX world may be up in this process:
    # shrink it to two for the reference and restore it after.
    was_up = jhvd.is_initialized()
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        opt = hvd_jax.DistributedOptimizer(
            optax.adamw(1e-4, weight_decay=0.01), fused_update=True)
        state = opt.init(params)

        def loss_fn(p, toks):
            logits = jmodel.apply({"params": p}, toks)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.roll(toks, -1, axis=1)).mean()

        def one_step(p, state, toks):
            loss, grads = jax.value_and_grad(loss_fn)(p, toks)
            upd, state = opt.update(grads, state, p)
            return (optax.apply_updates(p, upd), state,
                    hvd_jax.allreduce(loss), hvd_jax.allreduce_pytree(grads))

        P = jax.sharding.PartitionSpec
        step = hvd_jax.jit(one_step, in_specs=(P(), P(), P(hvd_jax.HVD_AXIS)),
                           out_specs=(P(), P(), P(), P()))
        losses, grads = [], []
        for _ in range(2):
            params, state, loss, g = step(params, state, jnp.asarray(tokens))
            losses.append(float(loss))
            grads.append(jax.device_get(g))
        return init, jax.device_get(params), losses, grads[0]
    finally:
        jhvd.shutdown()
        if was_up:
            jhvd.init()


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """The port's two steps in a 2-process gloo world (batch 1 per rank)
    and the JAX package's at world size 2, from the same flax init."""
    work = str(tmp_path_factory.mktemp("two_rank"))
    tokens = np.random.RandomState(0).randint(0, TINY["vocab_size"],
                                              (2, TINY["max_len"]))
    init, final, jlosses, jgrads = _jax_two_rank_reference(tokens)
    np.savez(os.path.join(work, "init.npz"),
             **{k: v.numpy() for k, v in params_from_jax(init).items()})
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TWO_RANK_WORKER, work, json.dumps(TINY)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            line = [l for l in out.splitlines() if l.startswith("RESULT ")]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(2)]
    return {"tokens": tokens, "jax_losses": jlosses,
            "jax_params": params_from_jax(final),
            "jax_first_grads": params_from_jax(jgrads), "results": results,
            "ranks": ranks}


def test_ranks_train_on_their_own_rows(two_rank_run):
    """Rank r holds row r of the seeded (batch * local_size, seq) array,
    as each JAX device holds its shard of ``P(HVD_AXIS)``."""
    tokens = two_rank_run["tokens"]
    for rank, got in enumerate(two_rank_run["ranks"]):
        np.testing.assert_array_equal(got["tokens"], tokens[rank:rank + 1])
    assert not np.array_equal(tokens[0], tokens[1])


def test_two_rank_losses_match_jax(two_rank_run):
    """The rank-averaged loss of both steps, on every rank, against the
    JAX package at world size 2 (rtol 1e-5, as at world size 1)."""
    for res in two_rank_run["results"]:
        np.testing.assert_allclose(res["losses"], two_rank_run["jax_losses"],
                                   rtol=1e-5)


def test_two_rank_params_match_jax(two_rank_run):
    """Parameters after two steps, on every rank, against the JAX package
    at world size 2: atol 2e-6, the world-of-one tests' tolerance. As
    there, the key biases (gradient zero in exact arithmetic) and the
    elements whose rank-averaged first gradient is eps-sized (|g| < 1e-6:
    Adam's lr * g / (|g| + 1e-8) turns each framework's float32 rounding of
    g into a different fraction of lr; here layers.0.mlp_out.weight[53, 89],
    g = -4.6e-8) are held to the two-step bound of at most lr per step."""
    want = two_rank_run["jax_params"]
    first = two_rank_run["jax_first_grads"]
    for got in two_rank_run["ranks"]:
        for name, ref in want.items():
            if name.endswith("attn.key.bias"):
                assert float(np.abs(got[name]).max()) <= 2 * 1e-4 * (1 + 1e-3)
                continue
            g, r = got[name], ref.numpy()
            eps_sized = np.abs(first[name].numpy()) < 1e-6
            assert np.abs(g - r)[eps_sized].max(initial=0.0) <= (
                4 * 1e-4 * (1 + 1e-3)), name
            np.testing.assert_allclose(g[~eps_sized], r[~eps_sized],
                                       atol=2e-6, rtol=0, err_msg=name)


FORBIDDEN = ("jax", "flax", "optax", "horovod_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """An AST check, not sys.modules: jax may be pre-imported."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "horovod_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad
