"""Device-resident dataset and whole-epoch training (port of
gabril_carla_tpu/train/device_data.py, single device).

The whole uint8 dataset sits in device memory (55k grayscale 180x320
frames are 3.2 GB of the H100's 80 GB), with the frame-stack window map
precomputed; each step gathers its batch on the device. An epoch is a
Python loop of train steps with no host-to-device traffic but the
permutation, and one host sync at its end. The sharded form
(``ShardedDeviceData``) is queued in ROADMAP.md (M12).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.dataset import EpisodeStore


class DeviceData:
    """Flat episode streams on ``device`` + window index maps."""

    def __init__(self, store: EpisodeStore, frame_stack: int, grayscale_store: bool = True,
                 device="cuda"):
        store.finalize()
        imgs = store.flat_images  # [T, H, W, C] uint8
        if grayscale_store and imgs.shape[-1] == 3:
            # store luma only: 3x less memory; format_obs_stack skips conversion
            imgs = (0.299 * imgs[..., 0] + 0.587 * imgs[..., 1] + 0.114 * imgs[..., 2]).astype(np.uint8)[..., None]
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


def make_epoch_fn(data: DeviceData, loss_grad_apply, steps_per_epoch: int, batch_size: int):
    """One epoch over shuffled batch indices: epoch(state, perm, rng) ->
    (state, mean metrics as 0-d device tensors).

    ``loss_grad_apply(state, batch, rng) -> (state, metrics)`` is the usual
    step. ``rng`` is a torch.Generator every step draws from, or a sequence
    of ``steps_per_epoch`` per-step draws.
    """
    arrays = data.arrays()

    def epoch(state, perm: torch.Tensor, rng=None):
        idx = perm[: steps_per_epoch * batch_size].to(data.device).reshape(steps_per_epoch, batch_size)
        if isinstance(rng, (list, tuple)) and len(rng) != steps_per_epoch:
            raise ValueError(f"need {steps_per_epoch} per-step draws, got {len(rng)}")
        history = []
        for i in range(steps_per_epoch):
            step_rng = rng[i] if isinstance(rng, (list, tuple)) else rng
            state, metrics = loss_grad_apply(state, gather_from(arrays, idx[i]), step_rng)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}

    return epoch
