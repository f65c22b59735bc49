"""Multi-GPU data parallelism on torch.distributed (port of
gabril_carla_tpu.parallel): torchrun initialisation and the ('data',
'model') mesh with its collectives."""

from .distributed import maybe_init_distributed
from .mesh import broadcast_state, make_mesh, make_multislice_mesh, pmean, shard_batch

__all__ = ["maybe_init_distributed", "make_mesh", "make_multislice_mesh", "shard_batch",
           "broadcast_state", "pmean"]
