"""Collectives, topology and the distributed optimizer of the PyTorch port
in a 2-process gloo world on the CPU.

One world serves the whole module: two ranks run every scenario once and
report their results as JSON; the tests check them against what the JAX
package's semantics give for the same per-rank inputs (mean over ranks,
integer means floor-divided in the integer dtype, broadcast of the root's
value). World-of-one elision and the no-GPU error run in this process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.fused import fuse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.optimizer import adamw

hvd.init(device="cpu")
r = hvd.rank()
out = {"topology": [hvd.size(), hvd.rank(), hvd.local_rank(),
                    hvd.local_size(), hvd.cross_size(), hvd.cross_rank(),
                    hvd.num_processes(), hvd.process_index()]}
x = torch.arange(6, dtype=torch.float32) * (r + 1)
avg = hvd.allreduce(x)
out["avg"] = avg.tolist()
out["avg_dtype"] = str(avg.dtype)
out["input_kept"] = x.tolist()
out["sum"] = hvd.allreduce(x, average=False).tolist()
xi = torch.tensor([3, 4, -5, 7], dtype=torch.int32) + r
ai = hvd.allreduce(xi)
out["int_avg"] = ai.tolist()
out["int_dtype"] = str(ai.dtype)
grouped = hvd.grouped_allreduce(
    [torch.full((2, 3), float(r)), torch.tensor([10 * r, 1], dtype=torch.int64),
     torch.full((4,), 2.0 * r, dtype=torch.float64)])
out["grouped"] = [g.tolist() for g in grouped]
out["grouped_dtypes"] = [str(g.dtype) for g in grouped]
out["bcast"] = hvd.broadcast(torch.full((3,), float(r) + 0.5), 1).tolist()
params = [torch.full((2, 2), float(r)), torch.full((3,), 10.0 + r)]
hvd.broadcast_parameters(params, root_rank=0)
out["bcast_params"] = [p.tolist() for p in params]
# Ranks hold different grads; the update must be that of the mean grad.
p = [torch.linspace(-1, 1, 5000), torch.linspace(0, 1, 7)]
g = [torch.linspace(0, 1, 5000) * (r + 1), torch.ones(7) * (1 - 2 * r)]
opt = hvd.DistributedOptimizer(adamw(0.1, weight_decay=0.0),
                               fused_update=True, compression="fp16")
upd, _ = opt.update(g, opt.init(p), p)
out["update"] = [u.tolist() for u in upd]
print("RESULT " + json.dumps(out), flush=True)
hvd.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=180)
            assert proc.returncode == 0, err[-3000:]
            line = [l for l in out.splitlines() if l.startswith("RESULT ")]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def test_topology(world):
    for rank, res in enumerate(world):
        assert res["topology"] == [2, rank, rank, 2, 1, 0, 2, rank]


def test_allreduce_float_average_and_sum(world):
    x = np.arange(6, dtype=np.float32)
    for res in world:
        np.testing.assert_allclose(res["avg"], (x + 2 * x) / 2)
        assert res["avg_dtype"] == "torch.float32"
        np.testing.assert_allclose(res["sum"], x + 2 * x)
    assert world[1]["input_kept"] == (2 * x).tolist()


def test_allreduce_integer_average_keeps_dtype(world):
    a = np.array([3, 4, -5, 7], np.int32)
    want = ((a + (a + 1)) // 2).tolist()  # floor division, as the JAX psum
    for res in world:
        assert res["int_avg"] == want
        assert res["int_dtype"] == "torch.int32"


def test_grouped_allreduce(world):
    for res in world:
        assert res["grouped"] == [[[0.5] * 3] * 2, [5, 1], [1.0] * 4]
        assert res["grouped_dtypes"] == ["torch.float32", "torch.int64",
                                         "torch.float64"]


def test_broadcast_and_broadcast_parameters(world):
    for res in world:
        assert res["bcast"] == [1.5] * 3
        assert res["bcast_params"] == [[[0.0, 0.0]] * 2, [10.0] * 3]


def test_distributed_optimizer_uses_mean_gradient(world):
    assert world[0]["update"] == world[1]["update"]
    p = [torch.linspace(-1, 1, 5000), torch.linspace(0, 1, 7)]
    g = [torch.linspace(0, 1, 5000) * 1.5, torch.zeros(7)]
    g = [t.half().float() for t in g]  # the fp16 wire
    opt = fuse(hvd.adamw(0.1, weight_decay=0.0))
    want, _ = opt.update(g, opt.init(p), p)
    for got, exp in zip(world[0]["update"], want):
        np.testing.assert_allclose(got, exp.numpy(), rtol=1e-6, atol=1e-7)


@pytest.fixture
def fresh(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    hvd.shutdown()
    yield
    hvd.shutdown()


def test_world_of_one_elides_collectives(fresh):
    with pytest.raises(hvd.NotInitializedError):
        hvd.size()
    hvd.init(device="cpu")
    assert (hvd.size(), hvd.rank(), hvd.device()) == (1, 0,
                                                     torch.device("cpu"))
    x = torch.ones(3)
    assert hvd.allreduce(x) is x
    assert hvd.broadcast(x, 0) is x
    assert hvd.grouped_allreduce([x])[0] is x
    with pytest.raises(ValueError, match="root_rank"):
        hvd.broadcast(x, 1)


def test_init_without_device_needs_a_gpu(fresh):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
