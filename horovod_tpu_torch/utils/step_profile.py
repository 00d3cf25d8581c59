"""Where the time of the BERT training step goes on the GPU.

Runs the main path of :mod:`horovod_tpu_torch.bert_pretraining` (same
flags: BERT-base, with ``--flash`` and ``--fused-loss`` as given) under
``torch.profiler`` for a few steps after a warm-up, and prints one JSON
line: device time per step summed by kernel class (the three flash
kernels, the three LM-head cross-entropy kernels, matmuls, the optimizer's
multi-tensor kernels, collectives, the rest), the host-clock step time,
the device's busy share of it, the costliest kernels, the host operators
with the most self CPU time (the profiler's own cost per operator
inflates the step time it reports), and, from ``cProfile`` over as many
steps again, the Python functions with the most own time::

    python -m horovod_tpu_torch.utils.step_profile --flash --fused-loss
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from horovod_tpu_torch import bert_pretraining as bp

_CLASSES = (
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
    ("flash_dq", ("flash_dq_kernel", "flash_dq_wgmma_kernel")),
    ("flash_dkv", ("flash_dkv_kernel", "flash_dkv_wgmma_kernel")),
    ("ce_fwd", ("ce_fwd_kernel", "ce_fwd_combine_kernel")),
    ("ce_dx", ("ce_dx_kernel",)),
    ("ce_dw", ("ce_dw_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("collective", ("nccl",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv=None) -> None:
    args = bp.parse_args(argv)
    model, opt, tokens = bp.build(args)
    options = bp.loss_options(args, tokens.device)
    for _ in range(3):
        bp.train_step(model, opt, tokens, **options)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            bp.train_step(model, opt, tokens, **options)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    by_class: dict = {}
    for e in kernels:
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + _device_us(e) / 1e3 / steps
    busy = sum(by_class.values())
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    # Python's view of the host time: which functions it is spent in.
    pstats_prof = cProfile.Profile()
    pstats_prof.enable()
    for _ in range(steps):
        bp.train_step(model, opt, tokens, **options)
    torch.cuda.synchronize()
    pstats_prof.disable()
    py = sorted(pstats.Stats(pstats_prof).stats.items(),
                key=lambda kv: kv[1][2], reverse=True)[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": {"layers": args.layers, "hidden": args.hidden,
                   "seq_len": args.seq_len, "batch": args.batch_size,
                   "flash": args.flash, "fused_loss": args.fused_loss,
                   "remat": args.remat, "dropout": args.dropout},
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": by_class,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "top_kernels": [{"name": e.key[:120], "class": kernel_class(e.key),
                         "ms_per_step": _device_us(e) / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top],
        "launches_per_step": sum(e.count for e in kernels) / steps,
        "top_host_ops": [{"name": e.key[:80],
                          "self_cpu_ms_per_step":
                              e.self_cpu_time_total / 1e3 / steps,
                          "calls_per_step": e.count / steps} for e in host],
        "top_python_functions": [
            {"function": f"{os.path.basename(fn)}:{line}:{name}",
             "tottime_ms_per_step": st[2] * 1e3 / steps,
             "calls_per_step": st[1] / steps}
            for (fn, line, name), st in py],
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
