"""Trainer: the BC and gaze-predictor epoch loop on one device (port of
gabril_carla_tpu/train/loop.py).

BaseTrainer's epoch loop (train/common/base_trainer.py:116-192) maps to:
with the dataset resident on the device, one epoch of steps that gather
their batches there (train/device_data.py); otherwise a host iterator of
shuffled numpy batches, each copied to the device for one train step.

Waiting in ROADMAP.md: ``mode="vqvae"`` and Oreo's pretrained
``dropout.vqvae_path`` (M11), ``resume`` (M9) and sharding over several
devices (M12); they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.dataset import BCDataset
from ..utils.logging import ExperimentLogger
from ..utils.profiling import StageTimer
from .bc import init_bc_state, make_bc_train_step
from .checkpoint import save_manifest, save_params
from .gaze_predictor import init_gaze_state, make_gaze_train_step
from .optim import build_optimizer

# Collapse-gated restore threshold for the gaze predictor (see train()):
# restore the best-epoch snapshot only when the final train loss is this
# many times worse than the best epoch's, i.e. only on a mid-run MSE-head
# blowup, never as silent best-checkpoint selection.
COLLAPSE_GATE = 2.0


class Trainer:
    """mode 'bc' (BCTrainer parity) or 'gaze' (GazePredictorTrainer parity)
    on ``device``."""

    def __init__(self, cfg, dataset: BCDataset, mode: str = "bc", device="cuda"):
        if mode == "vqvae":
            raise NotImplementedError("mode 'vqvae': the VQ-VAE is queued in ROADMAP.md (M11)")
        if mode not in ("bc", "gaze"):
            raise ValueError(f"unknown mode {mode}")
        if (mode == "bc" and cfg.get_path("dropout.method") == "Oreo"
                and cfg.get_path("dropout.vqvae_path", "")):
            raise NotImplementedError("dropout.vqvae_path: loading a pretrained VQ-VAE is queued "
                                      "in ROADMAP.md (M11)")
        if cfg.get_path("training.resume_interval", 0):
            raise NotImplementedError("training.resume_interval: full-state resume is queued in "
                                      "ROADMAP.md (M9)")
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
        # device-resident data: the whole dataset in device memory, each
        # epoch a loop of steps that gather on the device. "auto" takes it
        # when the frames stay under 40 GB of the card's 80 GB.
        dd = cfg.get_path("training.device_data", "auto")
        if dd == "auto":
            dd = sum(x.nbytes for x in dataset.store.images) < 40e9
        self.device_mode = bool(dd)

        self.logger = ExperimentLogger(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if mode == "bc":
            self.models, self.state = init_bc_state(cfg, gen, tx, self.device)
            self.step_fn = make_bc_train_step(self.models, cfg)
        else:
            (self.model, self.heatmapper), self.state = init_gaze_state(cfg, gen, tx, self.device)
            self.step_fn = make_gaze_train_step(self.model, self.heatmapper, cfg)
        if self.device_mode:
            from .device_data import DeviceData, make_epoch_fn

            self.device_data = DeviceData(dataset.store, cfg.data["frame_stack"],
                                          grayscale_store=cfg.model["grayscale"], device=self.device)
            self.epoch_fn = make_epoch_fn(self.device_data, self.step_fn, self.steps_per_epoch, bs)
        self.timer = StageTimer()
        self._rng = np.random.default_rng(seed)
        self._step_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._global_step = 0

    def train(self, resume: bool = False) -> dict:
        """Run the epoch loop; returns the last epoch's mean metrics."""
        if resume:
            raise NotImplementedError("resume: full-state resume is queued in ROADMAP.md (M9)")
        cfg = self.cfg
        epochs = cfg.get_path("training.epochs", 1)
        save_interval = cfg.get_path("training.save_interval", 50)
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
        for epoch in range(epochs):
            if self.device_mode:
                with self.timer.stage("epoch"):
                    perm = torch.from_numpy(self._rng.permutation(self.device_data.n_samples))
                    self.state, metrics = self.epoch_fn(self.state, perm, self._step_gen)
                    avg = {k: float(v) for k, v in metrics.items()}
            else:
                totals, count = {}, 0
                for batch in self.dataset.iter_batches(bs, self._rng):
                    with self.timer.stage("data"):
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

    def save(self, epoch: int):
        save_params(self.logger.ckpt_dir, epoch, self.state.params)
        if self.cfg.get_path("logging.save_params", True):
            extra = {"model_type": "gaze_predictor"} if self.mode == "gaze" else None
            save_manifest(self.logger.ckpt_dir, self.cfg, epoch, extra=extra)
