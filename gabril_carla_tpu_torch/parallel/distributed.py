"""Multi-process initialisation under torchrun (port of
gabril_carla_tpu/parallel/distributed.py).

The reference's torch stack detects torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK) and opens an NCCL process group
(vlm_gaze/train/common/distributed.py:11-47); the JAX package's counterpart
is one ``jax.distributed.initialize()``. Here it is PyTorch's own idiom: one
process per rank, launched by

    torchrun --nproc_per_node N -m gabril_carla_tpu_torch.cli.train_bc ...

NCCL on the card, gloo on the CPU. Without torchrun's variables this is a
no-op, so every CLI stays runnable without a launcher.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_init_distributed(device="cuda", verbose: bool = True) -> bool:
    """Open the default process group from torchrun's environment: NCCL for
    ``device="cuda"`` (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo
    for ``"cpu"``. Returns False, and does nothing, when any of ENV_KEYS is
    missing (a run without a launcher); True when the group is open."""
    if any(k not in os.environ for k in ENV_KEYS):
        return False
    if dist.is_initialized():
        return True
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    if verbose:
        print(f"torch.distributed: rank {rank}/{world} ({backend}, local rank "
              f"{os.environ['LOCAL_RANK']})", flush=True)
    return True
