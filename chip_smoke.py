#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU (an H100)::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. ``device``: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. ``build``: the nvcc builds of the flash-attention and LM-head loss
   kernels, started together (or their reuse), and the compiler's
   register, spill and shared-memory report.
3. ``flash_fwd``, ``flash_dq``, ``flash_dkv``: each CUDA kernel against its
   plain PyTorch version on the same inputs, at the training path's shape
   (8, 512, 12, 64) bf16 and on extra cases (causal, a ragged sequence, head
   dim 32). The tolerance is stated per output. Each line has the kernel's
   median time, the plain version's, the bound of the card for the same
   work, and ``F.scaled_dot_product_attention`` as a yardstick (timed here,
   never used by the port).
4. ``ce_fwd``, ``ce_dx``, ``ce_dw``: the LM-head cross-entropy kernels
   against their plain versions at the training path's shape (4096 tokens,
   hidden 768, vocabulary 30522) and on extra cases (ragged token counts,
   small ragged vocabularies, hidden 256 and 512), each with labels at
   columns 0 and V-1 and rows whose cotangent is 0. Each line has the
   kernel's median time, the plain version's, the bound, and the cuBLAS bf16
   products of the same shapes as a yardstick (timed here, never used by
   the port).
5. ``bert_step``: slice 1, full-width BERT-base training with ``--flash``
   through the port's entry points (``horovod_tpu_torch.bert_pretraining``):
   3 warm-up and 10 timed steps on one fixed random batch with the launch
   counters zeroed just before and read just after; the loss must be finite
   and fall, and one forward/backward with the plain attention must agree
   with the kernel path (loss within 2e-2, gradient cosine >= 0.99).
6. ``bert_step_fused_loss``: slice 2, the same with ``--flash
   --fused-loss`` (full width and depth, 3 + 10 steps): each LM-head kernel
   must launch once per step and each flash kernel 12 times, the loss must
   be finite and fall, and one forward/backward through the kernels must
   agree with the stock loss (``F.cross_entropy`` over the float32 lm_head
   logits) on the same weights and batch: loss within 2e-2, every
   gradient's cosine >= 0.99. Peak memory and step time are printed beside
   slice 1's.
7. The ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Output tolerances of a kernel against its plain version (which computes
# in float32 from the same bf16 inputs and rounds once at the end): bf16
# outputs within 2% of the largest reference magnitude (~2.5 bf16 ulps
# there; the kernels round P and dS to bf16 for the tensor cores), the
# float32 row log-sum-exp within 1e-3.
BF16_REL_TOL = 2e-2
LSE_ABS_TOL = 1e-3
# The LM-head kernels' float32 outputs (dW, db) against their plain
# versions, relative to the largest reference magnitude. Both sides sum in
# float32 the same products of the same bf16 operands (dlog rounded to bf16
# from float32 logits), so they differ by the order of the sums (~1e-6
# relative) and by the rare dlog element whose float32 value sits within
# rounding noise of a bf16 rounding boundary: far below 1e-3, which is
# tighter than the flash rows' 2e-2 for bf16 outputs.
F32_REL_TOL = 1e-3

MAIN_SHAPE = (8, 512, 12, 64)  # (batch, seq, heads, head_dim) of BERT-base
LAYERS = 12  # each kernel launches once per layer per step (checked below)
EXTRA_CASES = [  # (b*h, seq, head_dim, causal)
    (96, 384, 64, True), (6, 200, 64, False), (6, 200, 64, True),
    (8, 128, 32, False), (8, 136, 32, True)]
SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "horovod_tpu/ops/flash_attention.py:67",
            "flash_dq": "horovod_tpu/ops/flash_attention.py:168",
            "flash_dkv": "horovod_tpu/ops/flash_attention.py:199"}

CE_MAIN = (4096, 768, 30522)  # (tokens = 8 x 512, hidden, vocabulary)
CE_EXTRA = [  # (tokens, hidden, vocabulary)
    (1000, 768, 30522), (64, 768, 70), (300, 768, 1000), (100, 256, 70),
    (77, 512, 1000)]
CE_SOURCE = "horovod_tpu_torch/ops/csrc/chunked_loss.cu"
CE_REPLACES = {"ce_fwd": "horovod_tpu/ops/chunked_loss.py:181",
               "ce_dx": "horovod_tpu/ops/chunked_loss.py:233",
               "ce_dw": "horovod_tpu/ops/chunked_loss.py:254"}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# Device cycles (~10 ms at H100 clocks) the device spins before each timed
# window while the host queues the window's calls behind it.
SLEEP_CYCLES = 20_000_000


def median_ms(fn, reps=10, calls=20, warmup=3):
    """Device time per call (ms): CUDA events around ``calls`` calls that
    the host queues while the device is still spinning, so the window
    holds device work only and no launch gaps; median of ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls=200):
    """Host time per call (us) of issuing ``fn`` with no synchronisation:
    the wrapper's own cost (checks, allocation, the launch)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def max_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


def check_bf16(name, got, want):
    """Max abs error, and the same relative to the largest reference
    magnitude, after checking the tolerance."""
    err, scale = max_err(got, want)
    tol = BF16_REL_TOL * scale
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err, err / scale


def kernel_inputs(bh, s, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=g)
            .to(torch.bfloat16) for _ in range(4)]


def check_kernels(fa, bh, s, d, causal, seed=0):
    """Each kernel against its plain version on one input; returns the
    inputs and per-kernel max errors."""
    q, k, v, do = kernel_inputs(bh, s, d, seed)
    o, lse = fa.flash_fwd(q, k, v, causal)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
    delta = fa.attention_delta(do, o)
    dq = fa.flash_dq(q, k, v, lse, delta, do, causal)
    dk, dv = fa.flash_dkv(q, k, v, lse, delta, do, causal)
    rdq = fa.flash_dq_reference(q, k, v, lse, delta, do, causal)
    rdk, rdv = fa.flash_dkv_reference(q, k, v, lse, delta, do, causal)
    torch.cuda.synchronize()
    tag = f"({bh},{s},{d},causal={causal})"
    errs = {name: check_bf16(name + tag, got, want) for name, got, want in
            (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
    lse_err, lse_scale = max_err(lse, rlse)
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"lse{tag}: max abs err {lse_err}")
    errs["lse"] = (lse_err, lse_err / lse_scale)
    return (q, k, v, do, o, lse, delta), errs


def kernel_phases(fa, peak):
    """Phase 3: correctness on every case, timing at the main shape."""
    b, s, h, d = MAIN_SHAPE
    bh = b * h
    (q, k, v, do, o, lse, delta), main_errs = check_kernels(fa, bh, s, d,
                                                            False)
    extra = []
    for case in EXTRA_CASES:
        _, errs = check_kernels(fa, *case, seed=1)
        extra.append({"case": list(case),
                      "max_abs_err": {n: e[0] for n, e in errs.items()},
                      "max_rel_err": {n: e[1] for n, e in errs.items()}})

    # Least time of the card for the same work: each input read once, each
    # output written once, against the operations of the products.
    elt = bh * s * d
    works = {
        "flash_fwd": (4 * elt * 2 + bh * s * 4, 4 * bh * s * s * d),
        "flash_dq": (5 * elt * 2 + 2 * bh * s * 4, 6 * bh * s * s * d),
        "flash_dkv": (6 * elt * 2 + 2 * bh * s * 4, 8 * bh * s * s * d),
    }
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, False),
                      lambda: fa.flash_fwd_reference(q, k, v, False)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, lse, delta, do, False),
                     lambda: fa.flash_dq_reference(q, k, v, lse, delta, do,
                                                   False)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, lse, delta, do, False),
                      lambda: fa.flash_dkv_reference(q, k, v, lse, delta,
                                                     do, False)),
    }
    # Yardsticks: one PyTorch call per function, where one exists.
    q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
    sdpa_fwd_ms = median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4))
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    do4 = do.view(b, h, s, d)

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl)
        out.backward(do4)

    sdpa_fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    errs_of = {"flash_fwd": {"o": main_errs["o"], "lse": main_errs["lse"]},
               "flash_dq": {"dq": main_errs["dq"]},
               "flash_dkv": {"dk": main_errs["dk"], "dv": main_errs["dv"]}}
    rows = {}
    for name, (kernel, plain) in calls.items():
        nbytes, ops = works[name]
        bytes_ms = nbytes / peak.hbm_bytes_per_s * 1e3
        ops_ms = ops / peak.bf16_flops * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": max(e[0] for key, e in errs_of[name].items()
                               if key != "lse"),
            "ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sdpa_fwd_ms if name == "flash_fwd" else None,
        }
        emit(name, shape=[bh, s, d], causal=False,
             max_abs_err={n: e[0] for n, e in errs_of[name].items()},
             max_rel_err={n: e[1] for n, e in errs_of[name].items()},
             tolerance={
                 "bf16_outputs": f"{BF16_REL_TOL} x max|ref|",
                 "lse_abs": LSE_ABS_TOL},
             ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
             bound_ms=rows[name]["bound_ms"],
             bound_by=rows[name]["bound_by"],
             launches_per_step=LAYERS, host_us_per_call=host_us(kernel),
             sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
             extra_cases=extra if name == "flash_fwd" else None)
    return rows


def check_f32(name, got, want):
    """Max abs error and the same relative to the largest reference
    magnitude, after checking ``F32_REL_TOL``."""
    err, scale = max_err(got, want)
    if not err <= F32_REL_TOL * scale:
        raise AssertionError(f"{name}: max abs err {err} > "
                             f"{F32_REL_TOL} x {scale}")
    return err, err / scale


def ce_inputs(n, h, v, seed):
    """Unit-variance hidden states, a head at lecun-normal scale (logits
    ~ N(0, 1)), labels that include columns 0 and V-1, and a non-uniform
    cotangent of mean-loss size that is 0 on rows 2-4."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(v, h, device="cuda", generator=g) * h ** -0.5).to(
        torch.bfloat16)
    b = torch.randn(v, device="cuda", generator=g) * 0.1
    labels = torch.randint(0, v, (n,), device="cuda", generator=g)
    labels[0] = 0
    labels[1] = v - 1
    cot = torch.rand(n, device="cuda", generator=g) * (2.0 / n)
    cot[2:5] = 0.0
    return x, w, b, labels, cot


def check_ce(cl, n, h, v, seed=0):
    """Each loss kernel against its plain version on one input (the
    backward kernels from the kernel's lse, as in training); returns the
    inputs and per-output errors."""
    x, w, b, labels, cot = ce_inputs(n, h, v, seed)
    loss, lse = cl.ce_fwd(x, w, b, labels)
    dx = cl.ce_dx(x, w, b, labels, lse, cot)
    dw, db = cl.ce_dw(x, w, b, labels, lse, cot)
    rloss, rlse = cl.ce_fwd_reference(x, w, b, labels)
    rdx = cl.ce_dx_reference(x, w, b, labels, lse, cot)
    rdw, rdb = cl.ce_dw_reference(x, w, b, labels, lse, cot)
    torch.cuda.synchronize()
    tag = f"({n},{h},{v})"
    errs = {}
    for name, got, want in (("loss", loss, rloss), ("lse", lse, rlse)):
        err, scale = max_err(got, want)
        if not err <= LSE_ABS_TOL:
            raise AssertionError(f"{name}{tag}: max abs err {err}")
        errs[name] = (err, err / scale)
    errs["dx"] = check_bf16("dx" + tag, dx, rdx)
    errs["dw"] = check_f32("dw" + tag, dw, rdw)
    errs["db"] = check_f32("db" + tag, db, rdb)
    if float(dx[2:5].float().abs().max()) != 0.0:
        raise AssertionError(f"dx{tag}: rows with a zero cotangent moved")
    return (x, w, b, labels, cot, lse), errs


def ce_phases(cl, peak):
    """Phase 4: the LM-head loss kernels, correctness on every case and
    timing at the main shape."""
    n, h, v = CE_MAIN
    (x, w, b, labels, cot, lse), main_errs = check_ce(cl, n, h, v)
    extra = []
    for case in CE_EXTRA:
        _, errs = check_ce(cl, *case, seed=1)
        extra.append({"case": list(case),
                      "max_abs_err": {k: e[0] for k, e in errs.items()},
                      "max_rel_err": {k: e[1] for k, e in errs.items()}})

    # Least time of the card: each input read once, each output written
    # once (x and W in bf16, bias, int64 labels, f32 row statistics),
    # against the operations of the products (2 n h v each).
    common = n * h * 2 + v * h * 2 + v * 4 + n * 8
    works = {
        "ce_fwd": (common + 2 * n * 4, 2 * n * h * v),
        "ce_dx": (common + 2 * n * 4 + n * h * 2, 4 * n * h * v),
        "ce_dw": (common + 2 * n * 4 + v * h * 4 + v * 4, 4 * n * h * v),
    }
    calls = {
        "ce_fwd": (lambda: cl.ce_fwd(x, w, b, labels),
                   lambda: cl.ce_fwd_reference(x, w, b, labels)),
        "ce_dx": (lambda: cl.ce_dx(x, w, b, labels, lse, cot),
                  lambda: cl.ce_dx_reference(x, w, b, labels, lse, cot)),
        "ce_dw": (lambda: cl.ce_dw(x, w, b, labels, lse, cot),
                  lambda: cl.ce_dw_reference(x, w, b, labels, lse, cot)),
    }
    # Yardsticks: the cuBLAS bf16 products of the shapes each kernel
    # computes in its body (logits; then dlog.W for dx, dlog^T.x for dW).
    F = torch.nn.functional
    dlog = cl.ce_dlog_reference(x, w, b, labels, lse, cot).to(torch.bfloat16)
    library = {
        "ce_fwd": ("F.linear(x, W)", lambda: F.linear(x, w)),
        "ce_dx": ("F.linear(x, W), F.linear(dlog, W^T)",
                  lambda: (F.linear(x, w), F.linear(dlog, w.t()))),
        "ce_dw": ("F.linear(W, x), F.linear(dlog^T, x^T)",
                  lambda: (F.linear(w, x), F.linear(dlog.t(), x.t()))),
    }
    errs_of = {"ce_fwd": ("loss", "lse"), "ce_dx": ("dx",),
               "ce_dw": ("dw", "db")}
    rows = {}
    for name, (kernel, plain) in calls.items():
        nbytes, ops = works[name]
        bytes_ms = nbytes / peak.hbm_bytes_per_s * 1e3
        ops_ms = ops / peak.bf16_flops * 1e3
        lib_name, lib_fn = library[name]
        rows[name] = {
            "name": name, "route": "cuda", "source": CE_SOURCE,
            "replaces": CE_REPLACES[name],
            "max_abs_err": max(main_errs[k][0] for k in errs_of[name]),
            "ms": median_ms(kernel), "plain_ms": median_ms(plain, reps=5,
                                                           calls=3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # No one PyTorch call computes these functions: the cuBLAS
            # products below are a yardstick of the phase line only.
            "library_ms": None,
        }
        products_ms = median_ms(lib_fn)
        emit(name, shape={"tokens": n, "hidden": h, "vocab": v},
             max_abs_err={k: main_errs[k][0] for k in errs_of[name]},
             max_rel_err={k: main_errs[k][1] for k in errs_of[name]},
             tolerance={"loss_lse_abs": LSE_ABS_TOL,
                        "dx_bf16": f"{BF16_REL_TOL} x max|ref|",
                        "dw_db_f32": f"{F32_REL_TOL} x max|ref|"},
             ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
             bound_ms=rows[name]["bound_ms"],
             bound_by=rows[name]["bound_by"],
             launches_per_step=1, host_us_per_call=host_us(kernel, calls=50),
             library_ms=products_ms,
             library=f"cuBLAS bf16 {lib_name}: the kernel's products alone "
                     "(yardstick, not used by the port)",
             extra_cases=extra if name == "ce_fwd" else None)
    return rows


def plain_attention(q, k, v, bias=None):
    """Attention through the plain versions of the kernels (autograd)."""
    from horovod_tpu_torch.ops.flash_attention import flash_fwd_reference

    b, s, h, d = q.shape
    to_bhsd = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, s, d)  # noqa
    out, _ = flash_fwd_reference(to_bhsd(q), to_bhsd(k), to_bhsd(v), False)
    return out.view(b, h, s, d).permute(0, 2, 1, 3)


def loss_and_grads(bp, model, tokens, **options):
    model.zero_grad(set_to_none=True)
    loss = bp.loss_fn(model, tokens, **options)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                                  for n, p in model.named_parameters()}


def run_steps(bp, hvd, flags, counters):
    """The port's main path for ``flags``: build it, then 3 warm-up and 10
    timed steps with every launch counter zeroed just before and read just
    after. Checks that the loss is finite and falls."""
    args = bp.parse_args(flags)
    model, opt, tokens = bp.build(args)
    options = bp.loss_options(args, hvd.device())
    for module in counters:
        module.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(3 + 10):
        t0 = time.perf_counter()
        loss = float(bp.train_step(model, opt, tokens, **options))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = {}
    for module in counters:
        launches.update(module.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if model.cfg.num_layers != LAYERS:
        raise AssertionError(f"{model.cfg.num_layers} layers, not {LAYERS}")
    timed = statistics.median(step_ms[3:])
    return {"args": args, "model": model, "tokens": tokens,
            "losses": losses, "step_ms": step_ms, "timed": timed,
            "launches": launches, "peak_mem": peak_mem}


def check_launches(launches, per_step, steps):
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"{name} launched {n} times in the main "
                                 f"path, expected {per_step[name] * steps}")


def grad_cosines(grads_k, grads_p):
    """Cosine of each parameter's gradient between two runs; the key biases
    (zero in exact arithmetic: softmax ignores a shift shared by all keys,
    so both sides hold rounding noise only) are reported by norm instead."""
    cosines, skipped = {}, {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        if name.endswith("attn.key.bias"):
            skipped[name] = [float(gk.norm()), float(gp.norm())]
            continue
        if float(gp.norm()) == 0.0:
            continue
        cosines[name] = float(torch.nn.functional.cosine_similarity(
            gk.flatten(), gp.flatten(), dim=0))
    worst = min(cosines, key=cosines.get)
    if not cosines[worst] >= 0.99:
        raise AssertionError(f"grad cosine {worst}: {cosines[worst]}")
    return cosines, skipped, worst


def run_fields(run, peak, bp):
    args, model = run["args"], run["model"]
    flops = bp.flops_per_step(model.cfg, args.batch_size, args.seq_len)
    steps = len(run["losses"])
    return {
        "config": {"layers": args.layers, "hidden": args.hidden,
                   "heads": args.heads, "seq_len": args.seq_len,
                   "vocab": args.vocab, "batch_per_gpu": args.batch_size,
                   "params": sum(p.numel() for p in model.parameters()),
                   "flash": args.flash, "fused_loss": args.fused_loss},
        "losses": run["losses"], "step_ms": run["step_ms"],
        "step_ms_median_timed": run["timed"],
        "tokens_per_s_per_gpu":
            args.batch_size * args.seq_len / (run["timed"] / 1e3),
        "mfu": flops / (run["timed"] / 1e3) / peak.bf16_flops,
        "flops_per_step": flops, "peak_memory_bytes": run["peak_mem"],
        "launches": run["launches"],
        "launches_per_step": {n: c / steps
                              for n, c in run["launches"].items()},
    }


def bert_phase(bp, fa, hvd, peak):
    """Phase 5: slice 1's main path (``--flash``), then kernel vs plain
    attention on the same weights and batch."""
    from horovod_tpu_torch.models import TransformerLM

    run = run_steps(bp, hvd, ["--flash"], [fa])
    check_launches(run["launches"], dict.fromkeys(run["launches"], LAYERS),
                   len(run["losses"]))
    model, tokens = run["model"], run["tokens"]
    loss_k, grads_k = loss_and_grads(bp, model, tokens)
    plain = TransformerLM(dataclasses.replace(
        model.cfg, attention_fn=plain_attention)).to(hvd.device())
    plain.load_state_dict(model.state_dict())
    loss_p, grads_p = loss_and_grads(bp, plain, tokens)
    if not abs(loss_k - loss_p) <= 2e-2:
        raise AssertionError(f"loss kernel {loss_k} vs plain {loss_p}")
    cosines, skipped, worst = grad_cosines(grads_k, grads_p)
    emit("bert_step", **run_fields(run, peak, bp),
         plain_check={"loss_kernel": loss_k, "loss_plain": loss_p,
                      "min_grad_cosine": cosines[worst],
                      "min_grad_cosine_param": worst,
                      "params_compared": len(cosines),
                      "key_bias_grad_norms": skipped})
    return {"launches": run["launches"], "step_ms": run["timed"],
            "peak_memory_bytes": run["peak_mem"]}


def bert_fused_loss_phase(bp, fa, cl, hvd, peak, slice1):
    """Phase 6: slice 2's main path (``--flash --fused-loss``), then the
    loss kernels vs the stock loss on the same weights and batch."""
    run = run_steps(bp, hvd, ["--flash", "--fused-loss"], [fa, cl])
    per_step = {name: 1 if name in cl.LAUNCHES else LAYERS
                for name in run["launches"]}
    check_launches(run["launches"], per_step, len(run["losses"]))
    model, tokens = run["model"], run["tokens"]
    # Peak memory of one forward/backward alone (no optimizer step, no
    # gradients held from before) on each loss path.
    fwd_bwd_peak = {}
    for name, fused in (("kernels", True), ("stock", False)):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bp.loss_fn(model, tokens, fused_loss=fused).backward()
        fwd_bwd_peak[name] = torch.cuda.max_memory_allocated()
    loss_k, grads_k = loss_and_grads(bp, model, tokens, fused_loss=True)
    loss_s, grads_s = loss_and_grads(bp, model, tokens)
    if not abs(loss_k - loss_s) <= 2e-2:
        raise AssertionError(f"loss kernels {loss_k} vs stock {loss_s}")
    cosines, skipped, worst = grad_cosines(grads_k, grads_s)
    for name in ("lm_head.weight", "lm_head.bias"):
        if name not in cosines:
            raise AssertionError(f"{name} was not compared")
    emit("bert_step_fused_loss", **run_fields(run, peak, bp),
         slice1_step_ms_median_timed=slice1["step_ms"],
         slice1_peak_memory_bytes=slice1["peak_memory_bytes"],
         fwd_bwd_peak_memory_bytes=fwd_bwd_peak,
         stock_loss_check={"loss_kernels": loss_k, "loss_stock": loss_s,
                           "min_grad_cosine": cosines[worst],
                           "min_grad_cosine_param": worst,
                           "lm_head_cosines": {
                               n: cosines[n] for n in ("lm_head.weight",
                                                       "lm_head.bias")},
                           "params_compared": len(cosines),
                           "key_bias_grad_norms": skipped})
    return run["launches"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import bert_pretraining as bp
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import chunked_loss as cl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.utils.hardware import device_peak

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    peak = device_peak(0)
    if peak is None:
        raise RuntimeError(f"no peak rates known for {smi}")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peak_assumed=peak._asdict())

    t0 = time.perf_counter()
    # Both sources compile at once, unless already built.
    _build.load_all(["flash_attention", "chunked_loss"])
    fa._lib()
    cl._lib()
    libraries = {}
    for name in ("flash_attention", "chunked_loss"):
        info = _build.BUILD_INFO[name]
        with open(info["path"][:-3] + ".log") as fh:
            report = [line.strip() for line in fh
                      if "Compiling entry" in line or "registers" in line
                      or "spill" in line]
        libraries[name] = {"nvcc_seconds": info["seconds"],
                           "cached": info["cached"], "ptxas": report}
    emit("build", seconds=time.perf_counter() - t0, libraries=libraries)

    rows = kernel_phases(fa, peak)
    rows.update(ce_phases(cl, peak))
    slice1 = bert_phase(bp, fa, hvd, peak)
    launches = dict(slice1["launches"])
    launches.update({n: c for n, c in bert_fused_loss_phase(
        bp, fa, cl, hvd, peak, slice1).items() if n in cl.LAUNCHES})
    for name, row in rows.items():
        row["launches"] = launches[name]
    hvd.shutdown()
    print(json.dumps({"kernels": [rows[n] for n in (*REPLACES, *CE_REPLACES)]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
