#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU (an H100)::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. ``device``: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. ``build``: the nvcc builds of the four kernel sources (the mma.sync
   flash kernels, the wgmma flash forward, the wgmma flash backward, the
   LM-head loss), started together (or their reuse), the compiler's
   register, spill and shared-memory report, and the HGMMA (wgmma) and
   UTMALDG (TMA load) instruction counts of every wgmma kernel instance
   ({bf16, f16} x head dims {64, 128, 256}) from ``cuobjdump -sass``; a
   missing instance, a count of 0, a compiler note that wgmma were
   serialized, or a spill in any kernel fails the phase.
3. ``flash_fwd``, ``flash_dq``, ``flash_dkv``: each CUDA kernel against its
   plain PyTorch version on the same inputs, at the training path's shape
   (8, 512, 12, 64) bf16 and on extra cases (causal, ragged sequences, head
   dims 32, 128 and 256, head dims 8, 12, 48, 136 and 200 padded by the
   wrapper, float16 inputs computed in float16, float32 inputs at head
   dims 64 and 200), each case naming the route each kernel took. The
   tolerance is stated per output. Each line has the main path's kernel's
   median time (the wgmma route), the ``mma.sync`` route's time at the same
   shape, the plain version's, the bound of the card for the same work,
   host time per call by route, and one PyTorch call computing the same
   function as a yardstick (timed here, never used by the port):
   ``F.scaled_dot_product_attention``'s forward for the forward; the flash
   backward (``aten._scaled_dot_product_flash_attention_backward``, dQ, dK
   and dV in one call) for the other two.
4. ``ce_fwd``, ``ce_dx``, ``ce_dw``: the LM-head cross-entropy kernels
   against their plain versions at the training path's shape (4096 tokens,
   hidden 768, vocabulary 30522) and on extra cases (ragged token counts,
   small ragged vocabularies, hidden 256, 512 and 1024, hidden 16, 12 and
   1020 padded by the wrapper, float32 hidden states), each with labels at
   columns 0 and V-1 and rows whose cotangent is 0. Each line has the
   kernel's median time, the plain version's, the bound, and the cuBLAS
   bf16 products of the same shapes as a yardstick (timed here, never used
   by the port).
5. ``bert_step``: slice 1, full-width BERT-base training with ``--flash``
   through the port's entry points (``horovod_tpu_torch.bert_pretraining``):
   3 warm-up and 10 timed steps on one fixed random batch with the launch
   counters zeroed just before and read just after (all 12 forward, dQ and
   dK/dV launches of a step on the wgmma route, none on mma.sync); the
   loss must be finite and fall, and one forward/backward with the plain
   attention must agree with the kernel path (loss within 2e-2, gradient
   cosine >= 0.99).
6. ``bert_step_fused_loss``: slice 2, the same with ``--flash
   --fused-loss`` (full width and depth, 3 + 10 steps): each LM-head kernel
   must launch once per step and each flash kernel 12 times, the loss must
   be finite and fall, and one forward/backward through the kernels must
   agree with the stock loss (``F.cross_entropy`` over the float32 lm_head
   logits) on the same weights and batch: loss within 2e-2, every
   gradient's cosine >= 0.99. Peak memory and step time are printed beside
   slice 1's.
7. ``bert_large_fused_loss``: BERT-large widths (hidden 1024, 16 heads, MLP
   4096) with ``--flash --fused-loss``, depth cut to 2 layers: 3 steps on
   the card, the loss finite and falling, every flash launch on the wgmma
   route, the LM-head kernels at their hidden-1024 instance.
8. The ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# Output tolerances of a kernel against its plain version (which computes
# in float32 from the same bf16 inputs and rounds once at the end): bf16
# outputs within 2% of the largest reference magnitude (~2.5 bf16 ulps
# there; the kernels round P and dS to bf16 for the tensor cores), the
# float32 row log-sum-exp within 1e-3. Float32 inputs reach the kernels
# rounded to bf16 (the wrappers' documented precision), so their plain
# version runs on that rounding, and their outputs are held to the same
# tolerances. Float16 inputs are computed in float16 (P and dS rounded to
# f16, 3 more mantissa bits than bf16) and held to the same tolerance
# against the plain version on the same float16 inputs.
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
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
EXTRA_CASES = [  # (b*h, seq, head_dim, causal, dtype)
    (96, 384, 64, True, BF16), (6, 200, 64, False, BF16),
    (6, 200, 64, True, BF16), (8, 128, 32, False, BF16),
    (8, 136, 32, True, BF16), (24, 512, 128, False, BF16),
    (24, 384, 128, True, BF16), (6, 200, 128, True, BF16),
    (8, 136, 8, True, BF16), (8, 200, 48, False, BF16),
    (6, 70, 64, False, BF16), (6, 129, 128, True, BF16),
    (96, 512, 64, False, F32),
    # head dim 256, padded head dims 136, 200 and 12, float16 (computed in
    # float16; head dim 16 padded to 64), float32 above 128, and ragged
    # sequences at head dim 256
    (12, 512, 256, False, BF16), (12, 384, 256, True, BF16),
    (6, 200, 136, False, BF16), (6, 200, 200, True, BF16),
    (8, 128, 12, False, BF16),
    (96, 384, 64, True, F16), (24, 512, 128, False, F16),
    (8, 136, 16, False, F16),
    (6, 200, 200, False, F32),
    (6, 70, 256, False, BF16), (6, 129, 256, True, BF16)]
SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
WGMMA_SOURCE = "horovod_tpu_torch/ops/csrc/flash_fwd_wgmma.cu"
BWD_SOURCE = "horovod_tpu_torch/ops/csrc/flash_bwd_wgmma.cu"
REPLACES = {"flash_fwd": "horovod_tpu/ops/flash_attention.py:67",
            "flash_dq": "horovod_tpu/ops/flash_attention.py:168",
            "flash_dkv": "horovod_tpu/ops/flash_attention.py:199"}
# The main path's kernel of each flash row (the wgmma route) and its source.
WGMMA_KERNELS = {"flash_fwd": ("flash_fwd_wgmma_kernel", WGMMA_SOURCE),
                 "flash_dq": ("flash_dq_wgmma_kernel", BWD_SOURCE),
                 "flash_dkv": ("flash_dkv_wgmma_kernel", BWD_SOURCE)}

CE_MAIN = (4096, 768, 30522)  # (tokens = 8 x 512, hidden, vocabulary)
CE_EXTRA = [  # (tokens, hidden, vocabulary, hidden dtype)
    (1000, 768, 30522, BF16), (64, 768, 70, BF16), (300, 768, 1000, BF16),
    (100, 256, 70, BF16), (77, 512, 1000, BF16),
    (4096, 1024, 30522, BF16), (77, 1024, 1000, BF16), (300, 16, 1000, BF16),
    (300, 768, 1000, F32),
    # hidden sizes that are not a multiple of 8, padded by the wrapper
    (300, 12, 1000, BF16), (77, 1020, 1000, BF16)]
CE_SOURCE = "horovod_tpu_torch/ops/csrc/chunked_loss.cu"
CE_REPLACES = {"ce_fwd": "horovod_tpu/ops/chunked_loss.py:181",
               "ce_dx": "horovod_tpu/ops/chunked_loss.py:233",
               "ce_dw": "horovod_tpu/ops/chunked_loss.py:254"}


# Mangled kernel names: the name, then template arguments, e.g.
# ...flash_dq_wgmma_kernelI13__nv_bfloat16Li64EE... or ...ILi128EE...
_KERNEL_NAME = re.compile(
    r"\d([a-z][a-z_]*_kernel)(I[0-9A-Za-z_]*?E)?(?:E|v|$)")
_TYPE_ARGS = {"13__nv_bfloat16": "bf16", "6__half": "f16"}


def short_name(mangled):
    """``kernel<args>`` from a mangled kernel name, e.g.
    ``flash_dq_wgmma_kernel<bf16,64>``; the name alone where it has no
    template arguments."""
    found = _KERNEL_NAME.search(mangled)
    if found is None:
        return mangled
    types = re.findall(r"13__nv_bfloat16|6__half", found.group(2) or "")
    dims = re.findall(r"Li(\d+)E", found.group(2) or "")
    args = [_TYPE_ARGS[t] for t in types] + dims
    return f"{found.group(1)}<{','.join(args)}>" if args else found.group(1)


def ptxas_report(log):
    """``{kernel<instance>: "R registers, S B spill stores, L B spill
    loads"}`` from an ``nvcc -Xptxas -v`` log, its performance notes
    (e.g. wgmma serialized by the compiler), and the kernels that spill."""
    kernels, notes, spilled, name = {}, [], [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = short_name(entry.group(1))
            kernels[name] = ""
        elif "spill stores" in line and name:
            spills = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            kernels[name] += ", ".join(f"{n} B spill {k}" for n, k in spills)
            if any(int(n) for n, _ in spills):
                spilled.append(name)
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            kernels[name] = f"{regs} registers, {kernels[name]}"
        elif "Performance Loss" in line:
            notes.append(line.strip())
    return kernels, sorted(set(notes)), spilled


def wgmma_sass_counts(library):
    """HGMMA (wgmma) and UTMALDG (TMA tensor load) instructions in each
    compiled kernel instance of ``library`` (``cuobjdump -sass``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", library],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = counts.setdefault(
                short_name(line.split("Function :")[1].strip()),
                {"HGMMA": 0, "UTMALDG": 0})
        elif current is not None:
            for op in current:
                current[op] += op in line
    return counts


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


def kernel_inputs(bh, s, d, seed, dtype=BF16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=g).to(dtype)
            for _ in range(4)]


def check_kernels(fa, bh, s, d, causal, dtype=BF16, seed=0):
    """Each kernel against its plain version on one input (float16 inputs
    on themselves, computed in float16; others on their bf16 rounding,
    what the kernels compute on); returns the inputs, per-output max
    errors and the route each kernel took."""
    q, k, v, do = kernel_inputs(bh, s, d, seed, dtype)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.attention_delta(do, o)
    dq = fa.flash_dq(q, k, v, lse, delta, do, causal)
    dk, dv = fa.flash_dkv(q, k, v, lse, delta, do, causal)
    routes = {}
    for kernel in fa.KERNELS:
        took = [r for r in fa.ROUTES if fa.LAUNCHES[f"{kernel}_{r}"] >
                before[f"{kernel}_{r}"]]
        route_of = fa.fwd_route if kernel == "flash_fwd" else fa.bwd_route
        if took != [route_of(dtype, d)]:
            raise AssertionError(f"{kernel}({bh},{s},{d},{dtype}) took the "
                                 f"routes {took}")
        routes[kernel] = took[0]
    kd = F16 if dtype == F16 else BF16
    rq, rk, rv, rdo = (t.to(kd) for t in (q, k, v, do))
    ro, rlse = fa.flash_fwd_reference(rq, rk, rv, causal)
    rdq = fa.flash_dq_reference(rq, rk, rv, lse, delta, rdo, causal)
    rdk, rdv = fa.flash_dkv_reference(rq, rk, rv, lse, delta, rdo, causal)
    torch.cuda.synchronize()
    tag = f"({bh},{s},{d},causal={causal},{dtype})"
    for name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        if t.dtype != dtype or tuple(t.shape) != (bh, s, d):
            raise AssertionError(f"{name}{tag}: {t.dtype} {tuple(t.shape)}")
    errs = {name: check_bf16(name + tag, got, want) for name, got, want in
            (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
    lse_err, lse_scale = max_err(lse, rlse)
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"lse{tag}: max abs err {lse_err}")
    errs["lse"] = (lse_err, lse_err / lse_scale)
    return (q, k, v, do, o, lse, delta), errs, routes


def sdpa_flash_backward(q4, k4, v4, do4):
    """One call of PyTorch's flash-attention backward (dQ, dK and dV
    together) on (b, h, s, d) inputs, from its own forward's outputs: the
    library yardstick of the dQ and dK/dV kernels."""
    out, lse, cq, ck, mq, mk, seed, offset, _ = (
        torch.ops.aten._scaled_dot_product_flash_attention(q4, k4, v4))
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset)


def kernel_phases(fa, peak):
    """Phase 3: correctness on every case, timing at the main shape."""
    b, s, h, d = MAIN_SHAPE
    bh = b * h
    (q, k, v, do, o, lse, delta), main_errs, main_routes = check_kernels(
        fa, bh, s, d, False)
    extra = []
    for *case, dtype in EXTRA_CASES:
        _, errs, routes = check_kernels(fa, *case, dtype, seed=1)
        extra.append({"case": [*case, str(dtype)], "routes": routes,
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

    def kernel_call(name, route=None):
        if name == "flash_fwd":
            return lambda: fa.flash_fwd(q, k, v, False, route=route)
        fn = fa.flash_dq if name == "flash_dq" else fa.flash_dkv
        return lambda: fn(q, k, v, lse, delta, do, False, route=route)

    plain = {
        "flash_fwd": lambda: fa.flash_fwd_reference(q, k, v, False),
        "flash_dq": lambda: fa.flash_dq_reference(q, k, v, lse, delta, do,
                                                  False),
        "flash_dkv": lambda: fa.flash_dkv_reference(q, k, v, lse, delta, do,
                                                    False),
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
    sdpa_bwd_ms = median_ms(sdpa_flash_backward(q4, k4, v4,
                                                do.view(b, h, s, d)))
    library_of = {"flash_fwd": sdpa_fwd_ms, "flash_dq": sdpa_bwd_ms,
                  "flash_dkv": sdpa_bwd_ms}
    errs_of = {"flash_fwd": {"o": main_errs["o"], "lse": main_errs["lse"]},
               "flash_dq": {"dq": main_errs["dq"]},
               "flash_dkv": {"dk": main_errs["dk"], "dv": main_errs["dv"]}}
    rows = {}
    for name in fa.KERNELS:
        nbytes, ops = works[name]
        bytes_ms = nbytes / peak.hbm_bytes_per_s * 1e3
        ops_ms = ops / peak.bf16_flops * 1e3
        # The main path's kernel is the wgmma route; the mma.sync route's
        # time at the same shape, in the same call, stands beside it.
        kernel, source = WGMMA_KERNELS[name]
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "max_abs_err": max(e[0] for key, e in errs_of[name].items()
                               if key != "lse"),
            "ms": median_ms(kernel_call(name)),
            "plain_ms": median_ms(plain[name]),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_of[name],
            "kernel": kernel, "kernel_route": main_routes[name],
            "mma_sync_ms": median_ms(kernel_call(name, "mma")),
            "mma_sync_source": SOURCE,
        }
        emit(name, shape=[bh, s, d], causal=False,
             max_abs_err={n: e[0] for n, e in errs_of[name].items()},
             max_rel_err={n: e[1] for n, e in errs_of[name].items()},
             tolerance={
                 "bf16_f16_outputs": f"{BF16_REL_TOL} x max|ref|",
                 "lse_abs": LSE_ABS_TOL},
             ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
             bound_ms=rows[name]["bound_ms"],
             bound_by=rows[name]["bound_by"],
             route=main_routes[name], mma_sync_ms=rows[name]["mma_sync_ms"],
             launches_per_step=LAYERS,
             host_us_per_call_by_route={
                 r: host_us(kernel_call(name, r)) for r in fa.ROUTES},
             library_ms=rows[name]["library_ms"],
             library="F.scaled_dot_product_attention forward"
             if name == "flash_fwd" else
             "aten._scaled_dot_product_flash_attention_backward (dQ, dK, "
             "dV in one call)",
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


def ce_inputs(n, h, v, seed, dtype=BF16):
    """Unit-variance hidden states, a head at lecun-normal scale (logits
    ~ N(0, 1)), labels that include columns 0 and V-1, and a non-uniform
    cotangent of mean-loss size that is 0 on rows 2-4."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, device="cuda", generator=g).to(dtype)
    w = (torch.randn(v, h, device="cuda", generator=g) * h ** -0.5).to(
        torch.bfloat16)
    b = torch.randn(v, device="cuda", generator=g) * 0.1
    labels = torch.randint(0, v, (n,), device="cuda", generator=g)
    labels[0] = 0
    labels[1] = v - 1
    cot = torch.rand(n, device="cuda", generator=g) * (2.0 / n)
    cot[2:5] = 0.0
    return x, w, b, labels, cot


def check_ce(cl, n, h, v, dtype=BF16, seed=0):
    """Each loss kernel against its plain version on one input (the
    backward kernels from the kernel's lse, as in training). The kernels
    take the operands as ``kernel_operands`` makes them (bf16, zero-padded
    to the kernels' hidden size); the plain versions run on the unpadded
    bf16 operands, so the comparison holds the padding too. Returns the
    kernels' operands and per-output errors."""
    x, w, b, labels, cot = ce_inputs(n, h, v, seed, dtype)
    xk, wk = cl.kernel_operands(x, w)
    loss, lse = cl.ce_fwd(xk, wk, b, labels)
    dx = cl.ce_dx(xk, wk, b, labels, lse, cot)[:, :h]
    dw, db = cl.ce_dw(xk, wk, b, labels, lse, cot)
    dw = dw[:, :h]
    xr, wr = x.to(BF16), w.to(BF16)
    rloss, rlse = cl.ce_fwd_reference(xr, wr, b, labels)
    rdx = cl.ce_dx_reference(xr, wr, b, labels, lse, cot)
    rdw, rdb = cl.ce_dw_reference(xr, wr, b, labels, lse, cot)
    torch.cuda.synchronize()
    tag = f"({n},{h},{v},{dtype})"
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
    if dtype != BF16 or xk.shape[1] != h:
        # Through the public function: the kernels run (launch counts),
        # and dx comes back in the hidden states' dtype and width.
        xs, ws = x.clone().requires_grad_(), w.float().requires_grad_()
        before = dict(cl.LAUNCHES)
        cl.fused_softmax_cross_entropy(xs, ws, b, labels).backward(cot)
        if any(cl.LAUNCHES[k] != before[k] + 1 for k in before):
            raise AssertionError(f"fused{tag}: launches {cl.LAUNCHES}")
        if xs.grad.dtype != dtype or tuple(xs.grad.shape) != (n, h) or (
                tuple(ws.grad.shape) != (v, h)):
            raise AssertionError(f"fused{tag}: dx {xs.grad.dtype} "
                                 f"{tuple(xs.grad.shape)}")
        errs["fused_dx"] = check_bf16("fused_dx" + tag, xs.grad, rdx)
    return (xk, wk, b, labels, cot, lse), errs


def ce_phases(cl, peak):
    """Phase 4: the LM-head loss kernels, correctness on every case and
    timing at the main shape."""
    n, h, v = CE_MAIN
    (x, w, b, labels, cot, lse), main_errs = check_ce(cl, n, h, v)
    extra = []
    for *case, dtype in CE_EXTRA:
        _, errs = check_ce(cl, *case, dtype, seed=1)
        extra.append({"case": [*case, str(dtype)],
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


def run_steps(bp, hvd, flags, counters, layers=LAYERS, warmup=3, timed=10):
    """The port's main path for ``flags``: build it, then ``warmup`` and
    ``timed`` steps with every launch counter zeroed just before and read
    just after. Checks that the loss is finite and falls."""
    args = bp.parse_args(flags)
    model, opt, tokens = bp.build(args)
    options = bp.loss_options(args, hvd.device())
    for module in counters:
        module.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(warmup + timed):
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
    if model.cfg.num_layers != layers:
        raise AssertionError(f"{model.cfg.num_layers} layers, not {layers}")
    return {"args": args, "model": model, "tokens": tokens,
            "losses": losses, "step_ms": step_ms,
            "timed": statistics.median(step_ms[warmup:]),
            "launches": launches, "peak_mem": peak_mem}


def flash_per_step(layers):
    """Launches per step of each flash counter: every forward, dQ and dK/dV
    on the wgmma route, none on the mma.sync route."""
    per_step = {}
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        per_step.update({kernel: layers, kernel + "_wgmma": layers,
                         kernel + "_mma": 0})
    return per_step


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
    check_launches(run["launches"], flash_per_step(LAYERS),
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
    per_step = {**flash_per_step(LAYERS), **dict.fromkeys(cl.LAUNCHES, 1)}
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


LARGE_LAYERS = 2  # BERT-large's depth (24) cut to 2 for the smoke run


def bert_large_phase(bp, fa, cl, hvd, peak):
    """Phase 7: BERT-large widths (hidden 1024, 16 heads, MLP 4096) with
    ``--flash --fused-loss`` at a cut depth: 3 steps, loss finite and
    falling, every forward on the wgmma route (head dim 64) and the loss
    kernels at their hidden-1024 instance."""
    run = run_steps(bp, hvd, ["--flash", "--fused-loss", "--hidden", "1024",
                              "--heads", "16", "--layers", str(LARGE_LAYERS)],
                    [fa, cl], layers=LARGE_LAYERS, warmup=1, timed=2)
    per_step = {**flash_per_step(LARGE_LAYERS),
                **dict.fromkeys(cl.LAUNCHES, 1)}
    check_launches(run["launches"], per_step, len(run["losses"]))
    emit("bert_large_fused_loss", **run_fields(run, peak, bp),
         depth_cut={"layers": LARGE_LAYERS, "of": 24})


# The wgmma libraries and their kernels, each with instances
# {bf16, f16} x {64, 128, 256}.
WGMMA_LIBRARIES = {"flash_fwd_wgmma": ("flash_fwd_wgmma_kernel",),
                   "flash_bwd_wgmma": ("flash_dq_wgmma_kernel",
                                       "flash_dkv_wgmma_kernel")}


def build_phase(_build, fa, cl):
    """Phase 2: every kernel source built at once (or reused), with the
    compiler's report; fails on a spill in any kernel instance, on a ptxas
    note that wgmma were serialized, or on a wgmma kernel instance without
    HGMMA or UTMALDG instructions."""
    sources = [*fa.LIBRARIES, "chunked_loss"]
    t0 = time.perf_counter()
    _build.load_all(sources)
    for name in fa.LIBRARIES:
        fa.library(name)
    cl._lib()
    libraries, faults = {}, []
    for name in sources:
        info = _build.BUILD_INFO[name]
        with open(info["path"][:-3] + ".log") as fh:
            kernels, notes, spilled = ptxas_report(fh.read())
        libraries[name] = {"nvcc_seconds": info["seconds"],
                           "cached": info["cached"], "ptxas": kernels,
                           "ptxas_notes": notes}
        faults += [f"{name}: {k} spills" for k in spilled]
        if name in WGMMA_LIBRARIES:
            faults += [f"{name}: {n}" for n in notes if "serialized" in n
                       or "C7520" in n or "C7514" in n]
    sass = {}
    for name in WGMMA_LIBRARIES:
        sass[name] = wgmma_sass_counts(_build.BUILD_INFO[name]["path"])
        want = {f"{kernel}<{t},{d}>" for kernel in WGMMA_LIBRARIES[name]
                for t in ("bf16", "f16") for d in (64, 128, 256)}
        faults += [f"{name}: no {k}" for k in sorted(want - set(sass[name]))]
        faults += [f"{name}: {k} {c}" for k, c in sass[name].items()
                   if not (c["HGMMA"] and c["UTMALDG"])]
    emit("build", seconds=time.perf_counter() - t0, libraries=libraries,
         wgmma_sass=sass)
    if faults:
        raise AssertionError(f"build: {faults}")


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

    build_phase(_build, fa, cl)
    rows = kernel_phases(fa, peak)
    rows.update(ce_phases(cl, peak))
    slice1 = bert_phase(bp, fa, hvd, peak)
    launches = dict(slice1["launches"])
    launches.update({n: c for n, c in bert_fused_loss_phase(
        bp, fa, cl, hvd, peak, slice1).items() if n in cl.LAUNCHES})
    bert_large_phase(bp, fa, cl, hvd, peak)
    for name, row in rows.items():
        row["launches"] = launches[name]
    for name in fa.KERNELS:
        rows[name]["launches_by_route"] = {
            r: launches[f"{name}_{r}"] for r in fa.ROUTES}
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
