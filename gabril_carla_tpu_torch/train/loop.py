"""Trainer: the BC, gaze-predictor and VQ-VAE epoch loop (port of
gabril_carla_tpu/train/loop.py).

BaseTrainer's epoch loop (train/common/base_trainer.py:116-192) maps to:
with the dataset resident on the device, one epoch of steps that gather
their batches there (train/device_data.py); otherwise a host iterator of
shuffled numpy batches, each copied to the device for one train step.

Full-state resume: ``save_resume`` / ``restore_resume`` carry the params,
the optimizer state, the step count, the step generator's state, numpy's
bit-generator state and the keep-best trackers, so a killed run continues
bit for bit (``train(resume=True)``).

Data parallel over the 'data' ranks of a mesh (parallel/mesh.py; one
process per rank under torchrun): device-resident epochs shard whole
episodes over the ranks (train/device_data.py ShardedDeviceData) when there
are at least as many episodes as ranks; the host-batch path cuts every
batch into per-rank rows (``shard_batch``). Either way the train step
averages gradients and metrics over the ranks in one all-reduce, so the
parameters stay bitwise replicated. Otherwise every rank runs the
replicated single-device path. Only the mesh's first rank writes
checkpoints, params.json, resume states and metrics; every rank restores.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import BCDataset
from ..parallel.mesh import broadcast_state, data_group, data_size, first_rank, shard_batch
from ..utils.logging import ExperimentLogger
from ..utils.prng import prng_key, split
from ..utils.profiling import StageTimer
from .bc import init_bc_state, make_bc_train_step
from .checkpoint import (latest_resume_state, load_resume_tree, restore_params, save_manifest,
                         save_params, save_resume_state, tree_to)
from .gaze_predictor import init_gaze_state, make_gaze_train_step
from .optim import build_optimizer
from .vqvae import init_vqvae_state, make_revive_dead_codes, make_vqvae_train_step

# Collapse-gated restore threshold for the gaze predictor (see train()):
# restore the best-epoch snapshot only when the final train loss is this
# many times worse than the best epoch's, i.e. only on a mid-run MSE-head
# blowup, never as silent best-checkpoint selection.
COLLAPSE_GATE = 2.0
REVIVE_SEED = 77  # epoch e's revive draws: a generator seeded REVIVE_SEED + e
REVIVE_PROBE = 512  # samples the revive encodes


class Trainer:
    """mode 'bc' (BCTrainer parity), 'gaze' (GazePredictorTrainer parity) or
    'vqvae' (Oreo's quantizer pretraining) on ``device``."""

    def __init__(self, cfg, dataset: BCDataset, mode: str = "bc", device="cuda",
                 device_data=None, mesh=None):
        """``device_data``: an existing DeviceData of this dataset on
        ``device``, used as it is in single-device mode, so that successive
        Trainers (the protocol's gaze predictor, VQ-VAE and every method)
        share one copy of the frames on the card. ``mesh``: a ('data',
        'model') DeviceMesh (parallel/mesh.py make_mesh) to train data
        parallel over its 'data' ranks (module docstring)."""
        if mode not in ("bc", "gaze", "vqvae"):
            raise ValueError(f"unknown mode {mode}")
        self.cfg = cfg
        self.dataset = dataset
        self.mode = mode
        self.device = torch.device(device)
        bs = cfg.data["batch_size"]
        spe = dataset.steps_per_epoch(bs)
        if spe == 0:
            raise ValueError(f"batch_size {bs} exceeds dataset size {len(dataset)}")
        self.steps_per_epoch = spe
        tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, spe)
        seed = cfg.get_path("training.seed", 0)
        self.mesh = mesh
        n_data = data_size(mesh) if mesh is not None else 1
        # sharding assigns whole episodes to ranks, so it needs at least one
        # episode a rank (JAX loop.py:61)
        can_shard = n_data > 1 and dataset.store.n_demos >= n_data
        # device-resident data: the whole dataset (or this rank's shard) in
        # device memory, each epoch a loop of steps that gather on the
        # device. "auto" takes it when a shard's frames stay under 40 GB of
        # the card's 80 GB and are in memory (a lazy, disk-backed store
        # streams by construction).
        lazy = dataset.store.lazy
        dd = cfg.get_path("training.device_data", "auto")
        if dd == "auto":
            per_shard = sum(x.nbytes for x in dataset.store.images) / (n_data if can_shard else 1)
            dd = per_shard < 40e9 and not lazy
        elif dd and lazy:
            raise ValueError("training.device_data needs the images in memory: load the HDF5 "
                             "with cache_images=True")
        self.device_mode = bool(dd)
        self._sharded_device = self.device_mode and can_shard
        # the all-reduce: sharded epochs, or the host path's per-rank rows
        group = None
        if n_data > 1 and (self._sharded_device or not self.device_mode):
            group = data_group(mesh)

        self._is_main = mesh is None or dist.get_rank() == first_rank(mesh)
        self.logger = ExperimentLogger(cfg, write=self._is_main)
        if mesh is not None:  # every rank takes the first rank's run directory
            name = [self.logger.run_name]
            dist.broadcast_object_list(name, src=first_rank(mesh))
            if not self._is_main:
                self.logger = ExperimentLogger(cfg, run_name=name[0], write=False)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if mode == "bc":
            self.models, self.state = init_bc_state(cfg, gen, tx, self.device)
            self.step_fn = make_bc_train_step(self.models, cfg, group)
        elif mode == "gaze":
            (self.model, self.heatmapper), self.state = init_gaze_state(cfg, gen, tx, self.device)
            self.step_fn = make_gaze_train_step(self.model, self.heatmapper, cfg, group)
        else:
            self.model, self.state = init_vqvae_state(cfg, gen, tx, self.device)
            self.step_fn = make_vqvae_train_step(self.model, cfg, group)
            self._revive_fn = make_revive_dead_codes(self.model, cfg)
        if mesh is not None:
            broadcast_state(self.state, mesh)
        if self._sharded_device:
            from .device_data import ShardedDeviceData, make_sharded_epoch_fn

            self._local_bs = max(1, bs // n_data)
            self.device_data = ShardedDeviceData(dataset.store, cfg.data["frame_stack"], mesh,
                                                 grayscale_store=cfg.model["grayscale"],
                                                 device=self.device)
            self.epoch_fn = make_sharded_epoch_fn(self.device_data, self.step_fn,
                                                  self.steps_per_epoch, self._local_bs)
        elif self.device_mode:
            from .device_data import DeviceData, make_epoch_fn

            self.device_data = device_data if device_data is not None else DeviceData(
                dataset.store, cfg.data["frame_stack"], grayscale_store=cfg.model["grayscale"],
                device=self.device)
            self.epoch_fn = make_epoch_fn(self.device_data, self.step_fn, self.steps_per_epoch, bs)
        self.timer = StageTimer()
        self._rng = np.random.default_rng(seed)
        self._step_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # the sharded epochs' key: split once an epoch, then folded with the
        # rank (device_data.make_sharded_epoch_fn)
        self._step_key = prng_key(seed + 1)
        self._global_step = 0
        self._best_loss, self._best_params, self._best_epoch = float("inf"), None, -1
        if mode == "bc":
            self._maybe_load_vqvae()

    def train(self, resume: bool = False) -> dict:
        """Run the epoch loop; returns the last epoch's mean metrics.
        ``resume=True`` continues from the newest complete resume
        checkpoint of this run's ckpt_dir (fresh if there is none), and
        saves one every epoch unless ``training.resume_interval`` says
        otherwise (0 turns saving off; it is off by default without resume)."""
        cfg = self.cfg
        epochs = cfg.get_path("training.epochs", 1)
        save_interval = cfg.get_path("training.save_interval", 50)
        resume_interval = cfg.get_path("training.resume_interval", 1 if resume else 0)
        bs = cfg.data["batch_size"]
        last = {}
        # The gaze predictor keeps its LAST epoch, as the reference does
        # (train/common/base_trainer.py:164-180), unless the run collapsed:
        # a hot step can blow the MSE head into a constant predictor mid-run,
        # and every heat-consuming method would then evaluate against
        # degenerate heat. Only a final loss above COLLAPSE_GATE x the best
        # epoch's restores the best epoch's snapshot.
        keep_best = self.mode == "gaze"
        self._best_loss, self._best_params, self._best_epoch = float("inf"), None, -1
        start_epoch = self.restore_resume() if resume else 0
        for epoch in range(start_epoch, epochs):
            if self._sharded_device:
                with self.timer.stage("epoch"):
                    perm = self.device_data.epoch_perm(self._rng, self.steps_per_epoch,
                                                       self._local_bs)
                    self._step_key, sub = split(self._step_key)
                    self.state, metrics = self.epoch_fn(self.state, perm, sub)
                    avg = {k: float(v) for k, v in metrics.items()}
            elif self.device_mode:
                with self.timer.stage("epoch"):
                    perm = torch.from_numpy(self._rng.permutation(self.device_data.n_samples))
                    self.state, metrics = self.epoch_fn(self.state, perm, self._step_gen)
                    avg = {k: float(v) for k, v in metrics.items()}
            else:
                totals, count = {}, 0
                for batch in self.dataset.iter_batches(bs, self._rng):
                    with self.timer.stage("data"):
                        if self.mesh is not None:
                            batch = shard_batch(batch, self.mesh)
                        batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                    with self.timer.stage("step"):
                        self.state, metrics = self.step_fn(self.state, batch, self._step_gen)
                    count += 1
                    for k, v in metrics.items():
                        totals[k] = totals.get(k, 0.0) + v
                # one host sync per epoch
                with self.timer.stage("sync"):
                    avg = {k: float(v) / count for k, v in totals.items()}
            self._global_step += self.steps_per_epoch
            if self.mode == "vqvae":
                avg["dead_codes"] = self._revive_dead_codes(epoch)
            self.logger.log_scalars(self._global_step, {"epoch": epoch + 1, **avg})
            self.logger.print(
                f"epoch {epoch + 1}/{epochs}: " + ", ".join(f"{k}={v:.5f}" for k, v in avg.items()))
            last = avg
            if keep_best and avg.get("loss", float("inf")) < self._best_loss:
                self._best_loss, self._best_epoch = avg["loss"], epoch + 1
                # a copy: the live tensors would follow later updates
                self._best_params = {k: v.detach().clone() for k, v in self.state.params.items()}
            if (epoch + 1) % save_interval == 0 or (epoch + 1) == epochs:
                self.save(epoch + 1)
            if resume_interval and ((epoch + 1) % resume_interval == 0 or (epoch + 1) == epochs):
                self.save_resume(epoch + 1)
        collapsed = (keep_best and self._best_params is not None and self._best_epoch != epochs
                     and last.get("loss", 0.0) > COLLAPSE_GATE * self._best_loss)
        if collapsed:
            self.state = dataclasses.replace(self.state, params=self._best_params)
            self.save(epochs)  # the final checkpoint holds the restored params
            self.logger.print(
                f"collapse gate tripped: restored epoch {self._best_epoch} "
                f"(loss {self._best_loss:.5f}) over final epoch "
                f"({last.get('loss', float('nan')):.5f} > {COLLAPSE_GATE:g}x best)")
            last = {**last, "loss": self._best_loss, "kept_best_epoch": self._best_epoch}
        return last

    def _revive_dead_codes(self, epoch: int) -> int:
        """Between VQ-VAE epochs: re-seed the codebook rows no latent of the
        first REVIVE_PROBE samples maps to (vqvae.make_revive_dead_codes),
        with draws from a generator seeded REVIVE_SEED + epoch. The probe
        batch is gathered on the device when the dataset lives there. Under
        sharding the codes' usage is shard-local, so nothing is revived and
        the count is -1 (JAX loop.py:230-232)."""
        if self._sharded_device:
            return -1
        if self.device_mode:
            n = min(REVIVE_PROBE, self.device_data.n_samples)
            batch = self.device_data.gather(torch.arange(n, device=self.device))
        else:
            n = min(REVIVE_PROBE, len(self.dataset))
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.dataset.sample(np.arange(n)).items()}
        gen = torch.Generator(device=self.device).manual_seed(REVIVE_SEED + epoch)
        params, dead = self._revive_fn(self.state.params, batch, gen)
        self.state = dataclasses.replace(self.state, params=params)
        return int(dead)

    def save(self, epoch: int):
        if self._is_main:
            save_params(self.logger.ckpt_dir, epoch, self.state.params)
            if self.cfg.get_path("logging.save_params", True):
                extra = None
                if self.mode != "bc":
                    extra = {"model_type": "gaze_predictor" if self.mode == "gaze" else self.mode}
                save_manifest(self.logger.ckpt_dir, self.cfg, epoch, extra=extra)
        self._written()

    def _written(self):
        """Under a mesh, every rank waits until the first has written."""
        if self.mesh is not None:
            dist.barrier()

    def save_resume(self, epoch_done: int):
        """Full-state checkpoint after ``epoch_done`` epochs (checkpoint.py:
        save_resume_state); the mesh's first rank writes it."""
        if self._is_main:
            tree = {"params": self.state.params, "opt_state": self.state.opt_state,
                    "step": self.state.step, "step_gen": self._step_gen.get_state(),
                    "step_key": torch.from_numpy(self._step_key.astype(np.int64))}
            if self._best_params is not None:
                tree["best_params"] = self._best_params
            save_resume_state(self.logger.ckpt_dir, epoch_done, tree, {
                "global_step": self._global_step,
                "rng_state": self._rng.bit_generator.state,
                "best_loss": self._best_loss,
                "best_epoch": self._best_epoch,
                "has_best": self._best_params is not None,
            })
        self._written()

    def restore_resume(self) -> int:
        """Restore the newest complete resume checkpoint of this run's
        ckpt_dir. Returns the epoch to continue FROM (0: none found)."""
        found = latest_resume_state(self.logger.ckpt_dir)
        if found is None:
            return 0
        path, meta = found
        tree = load_resume_tree(path)
        self.state = dataclasses.replace(self.state, params=tree_to(tree["params"], self.device),
                                         opt_state=tree_to(tree["opt_state"], self.device),
                                         step=int(tree["step"]))
        self._step_gen.set_state(tree["step_gen"])
        self._step_key = tree["step_key"].numpy().astype(np.uint32)
        self._best_params = tree_to(tree["best_params"], self.device) if meta["has_best"] else None
        self._global_step = int(meta["global_step"])
        self._best_loss = float(meta["best_loss"])
        self._best_epoch = int(meta["best_epoch"])
        self._rng.bit_generator.state = meta["rng_state"]
        self.logger.print(f"resumed from epoch {meta['epoch_done']} (global step {self._global_step})")
        return int(meta["epoch_done"])

    def _maybe_load_vqvae(self):
        """Oreo: adopt a pretrained VQ-VAE's encoder and frozen quantizer
        (train_bc.py:87-99 parity) from its ``ep<N>`` checkpoint directory;
        a missing path only warns."""
        path = self.cfg.get_path("dropout.vqvae_path", "")
        if self.cfg.get_path("dropout.method") != "Oreo" or not path:
            return
        if not Path(path).exists():
            self.logger.print(f"Warning: VQ-VAE model not found at {path}")
            return
        loaded = restore_params(path, self.device)
        adopt = {k: v for k, v in loaded.items() if k.startswith(("encoder.", "quantizer."))}
        params = dict(self.state.params)
        bad = [k for k, v in adopt.items() if k not in params or params[k].shape != v.shape]
        if bad or not adopt:
            raise ValueError(f"{path} is not a VQ-VAE checkpoint for this encoder: {bad[:3]}")
        params.update(adopt)
        self.state = dataclasses.replace(self.state, params=params)
        self.logger.print(f"Loaded VQ-VAE from {path}")
