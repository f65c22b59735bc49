"""Device-resident dataset and whole-epoch training (port of
gabril_carla_tpu/train/device_data.py).

The whole uint8 dataset sits in device memory (55k grayscale 180x320
frames are 3.2 GB of the H100's 80 GB), with the frame-stack window map
precomputed; each step gathers its batch on the device. An epoch is a
Python loop of train steps with no host-to-device traffic but the
permutation, and one host sync at its end.

Sharded over the 'data' ranks of a mesh (``ShardedDeviceData``), each rank
holds whole episodes, assigned as the JAX package assigns them, so every
frame-stack window stays on its rank; each rank samples its own episodes
and the train step's all-reduce averages the gradients
(``make_sharded_epoch_fn``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.dataset import EpisodeStore
from ..parallel.mesh import data_rank, data_size
from ..utils.prng import fold_in, split


class DeviceData:
    """Flat episode streams on ``device`` + window index maps."""

    def __init__(self, store: EpisodeStore, frame_stack: int, grayscale_store: bool = True,
                 device="cuda"):
        store.finalize()
        imgs = luma_images(store, grayscale_store)  # [T, H, W, C] uint8
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        self.gazes = torch.from_numpy(store.flat_gazes).to(self.device)
        self.actions = torch.from_numpy(store.flat_actions).to(self.device)

        # window map: sample i (demo d, step t) -> S global frame rows
        s = frame_stack
        wins, acts = [], []
        for off, ln in zip(store.offsets, store.lengths):
            t = np.arange(ln)
            wins.append(np.clip(t[:, None] + np.arange(-(s - 1), 1)[None, :], 0, ln - 1) + off)
            acts.append(t + off)
        self.win_idx = torch.from_numpy(np.concatenate(wins)).to(self.device)  # [N, S] int64
        self.act_idx = torch.from_numpy(np.concatenate(acts)).to(self.device)  # [N]
        self.n_samples = int(self.win_idx.shape[0])

    def arrays(self) -> dict:
        return {"images": self.images, "gazes": self.gazes, "actions": self.actions,
                "win_idx": self.win_idx, "act_idx": self.act_idx}

    def gather(self, sample_idx: torch.Tensor) -> dict:
        """[B] sample rows -> training batch, gathered on the device."""
        return gather_from(self.arrays(), sample_idx)


def gather_from(arrays: dict, sample_idx: torch.Tensor) -> dict:
    win = arrays["win_idx"][sample_idx]  # [B, S]
    return {
        "obs_seq": arrays["images"][win],  # [B, S, H, W, C]
        "gaze_seq": arrays["gazes"][win],  # [B, S, P*2]
        "actions": arrays["actions"][arrays["act_idx"][sample_idx]],  # [B, A]
    }


def luma_images(store: EpisodeStore, grayscale_store: bool) -> np.ndarray:
    """The store's flat [T, H, W, C] uint8 frames, RGB reduced to luma when
    ``grayscale_store`` (3x less memory; format_obs_stack skips conversion)."""
    imgs = store.flat_images
    if grayscale_store and imgs.shape[-1] == 3:
        imgs = (0.299 * imgs[..., 0] + 0.587 * imgs[..., 1] + 0.114 * imgs[..., 2]).astype(np.uint8)[..., None]
    return imgs


class ShardedDeviceData:
    """This rank's shard of the dataset on ``device``: whole episodes,
    assigned greedily longest first to the least-loaded shard
    (JAX device_data.py:93-98), concatenated with windows clipped inside
    each episode (JAX :108-120). Every rank computes the whole assignment
    (``n_local`` of every shard) and keeps its own shard's frames."""

    def __init__(self, store: EpisodeStore, frame_stack: int, mesh, grayscale_store: bool = True,
                 device="cuda"):
        store.finalize()
        n_dev = data_size(mesh)
        self.n_dev, self.rank = n_dev, data_rank(mesh)
        lengths, offsets = np.asarray(store.lengths), np.asarray(store.offsets)
        if len(lengths) < n_dev:
            raise ValueError(f"need >= {n_dev} episodes to shard over {n_dev} ranks")
        bins = [[] for _ in range(n_dev)]
        loads = np.zeros(n_dev, np.int64)
        for e in np.argsort(lengths)[::-1]:
            d = int(np.argmin(loads))
            bins[d].append(int(e))
            loads[d] += lengths[e]
        self.n_local = loads.astype(np.int32)
        self.n_samples = int(self.n_local.sum())

        eps = bins[self.rank]
        frames = np.concatenate([np.arange(offsets[e], offsets[e] + lengths[e]) for e in eps])
        s, wins, cur = frame_stack, [], 0
        for e in eps:
            t = np.arange(lengths[e])
            wins.append(np.clip(t[:, None] + np.arange(-(s - 1), 1)[None, :], 0, lengths[e] - 1) + cur)
            cur += int(lengths[e])
        self.device = torch.device(device)
        imgs = luma_images(store, grayscale_store)
        self.images = torch.from_numpy(np.ascontiguousarray(imgs[frames])).to(self.device)
        self.gazes = torch.from_numpy(store.flat_gazes[frames]).to(self.device)
        self.actions = torch.from_numpy(store.flat_actions[frames]).to(self.device)
        self.win_idx = torch.from_numpy(np.concatenate(wins)).to(self.device)  # [n_local, S] int64
        self.act_idx = torch.arange(cur, device=self.device)

    def arrays(self) -> dict:
        return {"images": self.images, "gazes": self.gazes, "actions": self.actions,
                "win_idx": self.win_idx, "act_idx": self.act_idx}

    def epoch_perm(self, rng: np.random.Generator, steps_per_epoch: int,
                   local_bs: int) -> np.ndarray:
        """[n_dev, steps * local_bs] local sample indices, one shuffle per
        shard, cycled where a shard is short (JAX :135-145). Every rank draws
        all rows from the same generator, so the stream is JAX's single
        controller's, and takes its own row."""
        need = steps_per_epoch * local_bs
        rows = []
        for d in range(self.n_dev):
            p = rng.permutation(int(self.n_local[d]))
            reps = -(-need // max(1, len(p)))
            rows.append(np.tile(p, reps)[:need])
        return np.stack(rows).astype(np.int32)


def make_sharded_epoch_fn(data: ShardedDeviceData, step_fn, steps_per_epoch: int, local_bs: int):
    """One epoch on this rank's shard: epoch(state, perm [n_dev, steps *
    local_bs], key) -> (state, mean metrics). ``step_fn`` must carry the
    all-reduce (built with the mesh's 'data' group), so the state stays
    replicated and the metrics are already the mean over the ranks. The
    rank folds its index into the epoch's threefry key and splits the
    result once a step (JAX :161, :165), so its draws are the JAX shard's."""
    arrays = data.arrays()

    def epoch(state, perm: np.ndarray, key):
        idx = torch.from_numpy(perm[data.rank].astype(np.int64)).to(data.device)
        idx = idx.reshape(steps_per_epoch, local_bs)
        key = fold_in(key, data.rank)
        history = []
        for i in range(steps_per_epoch):
            key, sub = split(key)
            state, metrics = step_fn(state, gather_from(arrays, idx[i]), sub)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}

    return epoch


def make_epoch_fn(data: DeviceData, loss_grad_apply, steps_per_epoch: int, batch_size: int):
    """One epoch over shuffled batch indices: epoch(state, perm, rng) ->
    (state, mean metrics as 0-d device tensors).

    ``loss_grad_apply(state, batch, rng) -> (state, metrics)`` is the usual
    step. ``rng`` is the epoch's threefry key, split once a step (JAX
    :207), or a sequence of ``steps_per_epoch`` per-step draws.
    """
    arrays = data.arrays()

    def epoch(state, perm: torch.Tensor, rng=None):
        idx = perm[: steps_per_epoch * batch_size].to(data.device).reshape(steps_per_epoch, batch_size)
        if isinstance(rng, (list, tuple)) and len(rng) != steps_per_epoch:
            raise ValueError(f"need {steps_per_epoch} per-step draws, got {len(rng)}")
        history = []
        for i in range(steps_per_epoch):
            if isinstance(rng, (list, tuple)):
                step_rng = rng[i]
            else:
                rng, step_rng = split(rng)
            state, metrics = loss_grad_apply(state, gather_from(arrays, idx[i]), step_rng)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}

    return epoch
