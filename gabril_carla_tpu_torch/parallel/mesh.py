"""The ('data', 'model') mesh and its collectives (port of
gabril_carla_tpu/parallel/mesh.py).

The JAX package shards one controller's arrays over a device mesh and lets
XLA insert the gradient psum. Here every rank is a process of its own
(parallel/distributed.py) holding its shard: a batch's rows are cut per
rank (``shard_batch``), the replicated state starts from rank 0's
(``broadcast_state``), and the train steps average gradients and metrics
over the 'data' group in one all-reduce (``pmean``). The 'model' axis is
reserved, size 1 by default, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA = 0  # the mesh dim named "data" (dim 1 is "model")


def make_mesh(data: int | None = None, model: int = 1, device="cuda") -> DeviceMesh:
    """A ('data', 'model') mesh over every rank of the open process group;
    ``data`` defaults to world size // model."""
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data} x {model} does not cover the {world} ranks")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_multislice_mesh(model: int = 1, device="cuda") -> DeviceMesh:
    """'model' inside a group of neighbouring ranks, 'data' across groups: a
    row-major (data, model) grid over the ranks, so the gradient all-reduce
    of 'data' spans the groups once a step (JAX make_multislice_mesh)."""
    return make_mesh(None, model, device)


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(DATA)


def data_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(DATA)


def data_group(mesh: DeviceMesh):
    return mesh.get_group(DATA)


def first_rank(mesh: DeviceMesh) -> int:
    """The global rank at the mesh's origin: the one that writes."""
    return int(mesh.mesh.flatten()[0])


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's rows of a host batch (numpy arrays): the batch axis padded
    up to a multiple of the 'data' size by repeating the last row (JAX
    mesh.py:49-62, which keeps the loss weighting nearly unchanged), then cut
    into equal consecutive shards."""
    n, r = data_size(mesh), data_rank(mesh)

    def rows(x):
        rem = (-x.shape[0]) % n
        if rem:
            x = np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]

    return {k: rows(v) for k, v in batch.items()}


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts, lists, tuples and
    dataclasses; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` (as tree_map visits them)."""
    out = []
    tree_map(out.append, tree)
    return out


def broadcast_state(state, mesh: DeviceMesh):
    """Every tensor of ``state`` (a TrainState or any tree) from the mesh's
    first rank to all ranks, in place: the counterpart of JAX's
    replicated_sharding. Returns ``state``."""
    src = first_rank(mesh)
    for t in tree_leaves(state):
        dist.broadcast(t, src=src)
    return state


def pmean(trees: tuple, group) -> tuple:
    """The mean over ``group`` of every tensor in ``trees`` (flat dicts of
    tensors, e.g. gradients and metrics), in one all-reduce: the leaves are
    flattened into one float32 bucket, summed, divided by the group's size
    and cut back into their shapes and dtypes. Every rank gets the same
    values (JAX's ``lax.pmean``, bc.py:327-329)."""
    leaves = [(i, k, v) for i, tree in enumerate(trees) for k, v in tree.items()]
    bucket = torch.cat([v.detach().reshape(-1).float() for _, _, v in leaves])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    bucket = bucket / dist.get_world_size(group)
    out = [dict() for _ in trees]
    at = 0
    for i, k, v in leaves:
        out[i][k] = bucket[at:at + v.numel()].view(v.shape).to(v.dtype)
        at += v.numel()
    return tuple(out)


def all_gather_rows(tree, mesh: DeviceMesh, dim: int = 0):
    """Every tensor leaf of ``tree`` concatenated along ``dim`` over the
    'data' ranks, in rank order (bool leaves travel as uint8: gloo has no
    bool)."""
    group, n = data_group(mesh), data_size(mesh)

    def gather(t):
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim)
        return out.bool() if t.dtype == torch.bool else out

    return tree_map(gather, tree)
