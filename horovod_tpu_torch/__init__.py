"""PyTorch/CUDA port of :mod:`horovod_tpu`.

The same surface as the JAX package, ported module by module (the layout
mirrors ``horovod_tpu/``): world bring-up over ``torch.distributed``, the
collective verbs, the data-parallel optimizer with fused per-dtype
buffers, the transformer model, and flash attention with hand-written
CUDA kernels for Hopper. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from horovod_tpu_torch.common.topology import (  # noqa: F401
    NotInitializedError,
    cross_rank,
    cross_size,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    num_processes,
    process_index,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.compression import Compression, Compressor  # noqa: F401
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    allreduce,
    broadcast,
    grouped_allreduce,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    adamw,
    allreduce_pytree,
    apply_updates,
    broadcast_parameters,
)
