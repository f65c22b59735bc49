"""Train cells: the port's train step on batches held on the card.

The traffic file names the step (``"step": "bc"``, train/bc.py
make_bc_train_step, or ``"gaze"``, train/gaze_predictor.py
make_gaze_train_step), the batch, how many distinct batches the window
cycles through, how many first steps the reference follows and how many
steps are traced. Set-up builds the step, its TrainState (the port's
optimizer over the benchmark's weights) and the batches, and drives the
first steps through the window's own call on distinct batches; that same
state goes on into the window.
"""

from __future__ import annotations

import copy

import torch

from ..common import device_gen, make_params, sync
from ..counts import flops as F
from ..reference import train as ref_train
from ..trace import Stretch


def make_batch(cfg, batch: int, seed: int, index: int, device, actions: bool) -> dict:
    """One batch of ``batch`` rows drawn on ``device``: uint8 grayscale
    frames [B, S, H, W, 1]; gaze points [B, S, 2P] in [0, 1), of which
    each frame keeps the first n, n uniform in 0..P, the rest (-1, -1) as
    the data marks a frame with fewer fixations; and for BC driving
    actions [B, 7]: throttle U(0, 1), steer N(0, 0.3) clipped, brake 1
    with probability 0.2, gear 1."""
    d, g = cfg["data"], cfg["gaze"]
    gen = device_gen(seed, f"batch{index}", device)
    s, h, w, p = d["frame_stack"], d["img_height"], d["img_width"], g["max_points"]
    gaze = torch.rand((batch, s, p, 2), generator=gen, device=device)
    kept = torch.randint(0, p + 1, (batch, s, 1, 1), generator=gen, device=device)
    gaze = torch.where(torch.arange(p, device=device)[:, None] < kept, gaze, -1.0)
    out = {"obs_seq": torch.randint(0, 256, (batch, s, h, w, 1), generator=gen, device=device,
                                    dtype=torch.uint8),
           "gaze_seq": gaze.reshape(batch, s, p * 2)}
    if actions:
        u = torch.rand((batch, 3), generator=gen, device=device)
        steer = (0.3 * torch.randn(batch, generator=gen, device=device)).clamp(-1.0, 1.0)
        zero = torch.zeros(batch, device=device)
        out["actions"] = torch.stack([u[:, 0], steer, (u[:, 1] < 0.2).float(), zero, zero, zero,
                                      torch.ones(batch, device=device)], 1)[:, :d["action_dim"]]
    return out


class Cell:
    rate_metric = "train_samples_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.kind = t["step"]
        self.cfg = copy.deepcopy(ctx.config["policy" if self.kind == "bc" else "gaze_predictor"])
        self.batch = self.per_unit = t["batch"]
        self.cfg["data"]["batch_size"] = self.batch
        self.spe = t["steps_per_epoch"]
        self.units_done = 0

    def setup(self):
        from gabril_carla_tpu_torch.train.optim import TrainState, build_optimizer
        from gabril_carla_tpu_torch.utils.config import Config

        ctx, dev = self.ctx, self.ctx.device
        cfg = Config(copy.deepcopy(self.cfg))
        if self.kind == "bc":
            from gabril_carla_tpu_torch.train.bc import build_bc_models, make_bc_train_step

            model = build_bc_models(cfg, dev)
            self.step = make_bc_train_step(model, cfg)
        else:
            from gabril_carla_tpu_torch.train.gaze_predictor import build_gaze_models, make_gaze_train_step

            model, heatmapper = build_gaze_models(cfg, dev)
            self.step = make_gaze_train_step(model, heatmapper, cfg)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        part = "policy" if self.kind == "bc" else "gaze_predictor"
        self.params0 = make_params(shapes, ctx.seed, "weights", dev, ctx.config.get("init_scale", {}).get(part))
        tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=self.spe)
        state = TrainState.create(dict(self.params0), tx)
        t = ctx.traffic
        self.batches = [make_batch(self.cfg, self.batch, ctx.seed, i, dev, self.kind == "bc")
                        for i in range(t["distinct_batches"])]
        losses = []
        for i in range(t["checked_steps"]):
            state, metrics = self.step(state, self.batches[i])
            losses.append(metrics["loss"])
            if i == 0:
                mu1 = state.opt_state["mu"]
        self.prog = ref_train.program_readings(losses, mu1, state.params, self.params0)
        self.state = state
        self.next = t["checked_steps"]
        sync(dev)

    def run_unit(self):
        self.state, _ = self.step(self.state, self.batches[self.next % len(self.batches)])
        self.next += 1
        self.units_done += self.batch

    def trace(self):
        stretch = Stretch(self.ctx.device, self.ctx.traffic["trace_steps"])
        stretch.start()
        for _ in range(stretch.units):
            self.run_unit()
        stretch.stop()
        return stretch.read()

    def flops_per_unit(self) -> dict:
        if self.kind == "bc":
            return F.bc_train_step(self.cfg, self.batch)
        return F.gaze_train_step(self.cfg, self.batch)

    def free_program(self):
        n = self.ctx.traffic["checked_steps"]
        self.state = self.step = None
        self.batches = self.batches[:n]

    def check(self) -> dict:
        ref = ref_train.follow(self.kind, self.cfg, self.params0, self.batches, self.spe)
        return ref_train.train_numbers(self.prog, ref)
