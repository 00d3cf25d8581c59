#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU (an H100)::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. ``device``: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. ``build``: the nvcc build of the flash-attention kernels (or its reuse)
   and the compiler's register/spill report.
3. ``flash_fwd``, ``flash_dq``, ``flash_dkv``: each CUDA kernel against its
   plain PyTorch version on the same inputs, at the training path's shape
   (8, 512, 12, 64) bf16 and on extra cases (causal, a ragged sequence, head
   dim 32). The tolerance is stated per output. Each line has the kernel's
   median time, the plain version's, the bound of the card for the same
   work, and ``F.scaled_dot_product_attention`` as a yardstick (timed here,
   never used by the port).
4. ``bert_step``: full-width BERT-base training through the port's entry
   points (``horovod_tpu_torch.bert_pretraining``): 3 warm-up and 10 timed
   steps on one fixed random batch with the launch counters zeroed just
   before and read just after; the loss must be finite and fall, and one
   forward/backward with the plain attention must agree with the kernel
   path (loss within 2e-2, gradient cosine >= 0.99).
5. The ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
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

MAIN_SHAPE = (8, 512, 12, 64)  # (batch, seq, heads, head_dim) of BERT-base
LAYERS = 12  # each kernel launches once per layer per step (checked below)
EXTRA_CASES = [  # (b*h, seq, head_dim, causal)
    (96, 384, 64, True), (6, 200, 64, False), (6, 200, 64, True),
    (8, 128, 32, False), (8, 136, 32, True)]
SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "horovod_tpu/ops/flash_attention.py:67",
            "flash_dq": "horovod_tpu/ops/flash_attention.py:168",
            "flash_dkv": "horovod_tpu/ops/flash_attention.py:199"}


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


def plain_attention(q, k, v, bias=None):
    """Attention through the plain versions of the kernels (autograd)."""
    from horovod_tpu_torch.ops.flash_attention import flash_fwd_reference

    b, s, h, d = q.shape
    to_bhsd = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, s, d)  # noqa
    out, _ = flash_fwd_reference(to_bhsd(q), to_bhsd(k), to_bhsd(v), False)
    return out.view(b, h, s, d).permute(0, 2, 1, 3)


def loss_and_grads(bp, model, tokens):
    model.zero_grad(set_to_none=True)
    loss = bp.loss_fn(model, tokens)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                         for n, p in model.named_parameters()}


def bert_phase(bp, fa, hvd, peak):
    """Phase 4: the port's main path, then kernel vs plain attention."""
    from horovod_tpu_torch.models import TransformerLM

    args = bp.parse_args(["--flash"])
    model, opt, tokens = bp.build(args)
    n_params = sum(p.numel() for p in model.parameters())
    flops = bp.flops_per_step(model.cfg, args.batch_size, args.seq_len)

    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(3 + 10):
        t0 = time.perf_counter()
        loss = float(bp.train_step(model, opt, tokens))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = dict(fa.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if model.cfg.num_layers != LAYERS:
        raise AssertionError(f"{model.cfg.num_layers} layers, not {LAYERS}")
    expected = LAYERS * len(losses)
    for name, n in launches.items():
        if n != expected:
            raise AssertionError(f"{name} launched {n} times in the main "
                                 f"path, expected {expected}")
    timed = statistics.median(step_ms[3:])
    tok_per_s = args.batch_size * args.seq_len / (timed / 1e3)

    # Same weights, same batch: kernel attention vs the plain versions.
    loss_k, grads_k = loss_and_grads(bp, model, tokens)
    plain = TransformerLM(dataclasses.replace(
        model.cfg, attention_fn=plain_attention)).to(hvd.device())
    plain.load_state_dict(model.state_dict())
    loss_p, grads_p = loss_and_grads(bp, plain, tokens)
    if not abs(loss_k - loss_p) <= 2e-2:
        raise AssertionError(f"loss kernel {loss_k} vs plain {loss_p}")
    cosines, skipped = {}, {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        if name.endswith("attn.key.bias"):
            # Exactly zero in exact arithmetic (softmax ignores a shift
            # shared by all keys); both sides hold rounding noise only.
            skipped[name] = [float(gk.norm()), float(gp.norm())]
            continue
        if float(gp.norm()) == 0.0:
            continue
        cosines[name] = float(torch.nn.functional.cosine_similarity(
            gk.flatten(), gp.flatten(), dim=0))
    worst = min(cosines, key=cosines.get)
    if not cosines[worst] >= 0.99:
        raise AssertionError(f"grad cosine {worst}: {cosines[worst]}")
    emit("bert_step", config={"layers": args.layers, "hidden": args.hidden,
                              "heads": args.heads, "seq_len": args.seq_len,
                              "vocab": args.vocab,
                              "batch_per_gpu": args.batch_size,
                              "params": n_params, "world_size": hvd.size()},
         losses=losses, step_ms=step_ms, step_ms_median_timed=timed,
         tokens_per_s_per_gpu=tok_per_s,
         mfu=flops / (timed / 1e3) / peak.bf16_flops,
         flops_per_step=flops, peak_memory_bytes=peak_mem,
         launches=launches,
         launches_per_step={n: c / len(losses) for n, c in launches.items()},
         plain_check={"loss_kernel": loss_k, "loss_plain": loss_p,
                      "min_grad_cosine": cosines[worst],
                      "min_grad_cosine_param": worst,
                      "params_compared": len(cosines),
                      "key_bias_grad_norms": skipped})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import bert_pretraining as bp
    from horovod_tpu_torch.ops import _build
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
    fa._lib()  # builds csrc/flash_attention.cu unless already built
    info = _build.BUILD_INFO["flash_attention"]
    with open(info["path"][:-3] + ".log") as fh:
        report = [line.strip() for line in fh
                  if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=info[
        "seconds"], cached=info["cached"], ptxas=report)

    rows = kernel_phases(fa, peak)
    launches = bert_phase(bp, fa, hvd, peak)
    for name, row in rows.items():
        row["launches"] = launches[name]
    hvd.shutdown()
    print(json.dumps({"kernels": [rows[n] for n in REPLACES]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
