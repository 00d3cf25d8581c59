"""World bring-up and rank discovery over ``torch.distributed``.

Counterpart of :mod:`horovod_tpu.common.topology`. There a rank is a chip
of a ``jax`` mesh; here a rank is one process driving one device, and
the world is a ``torch.distributed`` process group.

==================  ==========================================================
concept             here
==================  ==========================================================
world               the default process group (NCCL on CUDA, gloo on CPU);
                    none is created for a world of one
rank / size         ``RANK`` / ``WORLD_SIZE`` (one process per device)
local_comm          the processes of one host: ``LOCAL_RANK`` /
                    ``LOCAL_WORLD_SIZE`` (the latter defaults to the world
                    size, i.e. one host)
cross_comm          one representative per host: ``rank // local_size``
==================  ==========================================================

The rendezvous address comes from ``MASTER_ADDR`` / ``MASTER_PORT``.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist


class NotInitializedError(ValueError):
    """Raised by the getters before :func:`init`."""

    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init().")


class _Topology:
    def __init__(self) -> None:
        self.initialized = False
        self.lock = threading.Lock()
        self.device = None
        self.size = 1
        self.rank = 0
        self.local_size = 1
        self.local_rank = 0
        self.owns_group = False


_state = _Topology()


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def init(device=None) -> None:
    """Initialize the world from the launcher's environment.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``. With CUDA the
    process binds ``cuda:LOCAL_RANK`` and the backend is NCCL; on the CPU
    it is gloo. A world of one creates no process group. Idempotent.
    """
    with _state.lock:
        if _state.initialized:
            return
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init(): no CUDA device is visible; "
                    "pass device='cpu' to run on the CPU")
            device = "cuda"
        device = torch.device(device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        size = _env_int("WORLD_SIZE", 1)
        rank = _env_int("RANK", 0)
        local_rank = _env_int("LOCAL_RANK", rank)
        local_size = _env_int("LOCAL_WORLD_SIZE", size)
        if not (0 <= rank < size and 0 <= local_rank < local_size):
            raise ValueError(
                f"inconsistent world: RANK={rank} WORLD_SIZE={size} "
                f"LOCAL_RANK={local_rank} LOCAL_WORLD_SIZE={local_size}")
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
        owns = False
        if size > 1 and not dist.is_initialized():
            addr = os.environ.get("MASTER_ADDR", "localhost")
            port = _env_int("MASTER_PORT", 29500)
            dist.init_process_group(
                backend="nccl" if device.type == "cuda" else "gloo",
                init_method=f"tcp://{addr}:{port}",
                world_size=size, rank=rank)
            owns = True
        _state.device = device
        _state.size = size
        _state.rank = rank
        _state.local_size = local_size
        _state.local_rank = local_rank
        _state.owns_group = owns
        _state.initialized = True


def shutdown() -> None:
    """Tear down the world (destroys the process group init created)."""
    with _state.lock:
        if not _state.initialized:
            return
        if _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _state.initialized = False
        _state.owns_group = False
        _state.device = None


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _Topology:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def device() -> torch.device:
    """The device this process computes on."""
    return _require_init().device


def size() -> int:
    """Total number of ranks (one process per device)."""
    return _require_init().size


def rank() -> int:
    """Global rank of this process."""
    return _require_init().rank


def local_size() -> int:
    """Number of ranks on this host."""
    return _require_init().local_size


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    return _require_init().local_rank


def cross_size() -> int:
    """Number of hosts in the world."""
    st = _require_init()
    return st.size // st.local_size


def cross_rank() -> int:
    """This host's index among the world's hosts."""
    st = _require_init()
    return st.rank // st.local_size


def num_processes() -> int:
    return _require_init().size


def process_index() -> int:
    return _require_init().rank
