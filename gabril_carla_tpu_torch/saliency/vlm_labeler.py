"""VLM pseudo-gaze on the card: a Kimi-VL model (models/kimi_vl.py) picks,
among the detector's boxes, the ones a driver would look at, and their
centres become the gaze coordinates, as the reference's
saliency_pipeline/vlm_filter.py does with GroundingDINO boxes and a
Qwen2.5-VL filter. Here the boxes are the scene graph's (``scene_boxes``,
the stand-in for GroundingDINO) and every world of a tick is labeled in
one ragged batch.

A world's prompt, at the token-id level (the tokenizer's files are not in
the repository): a template of ``template_len`` ids drawn once from the
seed, with the image's tokens in place of ids ``image_at:image_at + n``,
then the nearest visible boxes (depth under ``max_depth``, at most
``max_boxes``), 7 ids each: an opening separator, the class, the box's
corners quantised to 0-999 over the frame, a closing separator. The gray
frame, repeated to RGB and normalised to [-1, 1], is zero-padded at the
bottom and right to a multiple of 28 (196 x 336: 84 image tokens). The
answer is the prefill's greedy id and ``decode_steps`` more, a fixed count
with no end-of-answer stop; an id in the box-index range picks that box,
and the first ``gaze_points`` distinct picks become centres, then
coordinates (``bboxes_to_gaze_coords``), -1 where there are fewer.

The special ids sit at the top of the vocabulary (``TokenLayout``).

With random weights (``KimiVL.random``) the routers' correction biases are
drawn at ``router_bias_std`` and then fitted on the worlds' first frames
(``balance``, models/kimi_vl.py ``balance_routers``), so that the heaviest
expert of each layer takes about ``balance_target`` times the mean load, as
in routers trained with auxiliary-loss-free balancing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..models.kimi_vl import balance_routers
from ..ops.raster import COL_BIKE, COL_CAR, COL_STATIC, COL_WALKER
from ..utils.profiling import span
from .pseudo_gaze import bboxes_to_gaze_coords

CLASS_COLORS = (COL_CAR, COL_BIKE, COL_STATIC, COL_WALKER)  # a box's class: its render color's index
COORD_BINS = 1000


@dataclasses.dataclass(frozen=True)
class LabelerConfig:
    seed: int = 0
    template_len: int = 48
    image_at: int = 24
    max_boxes: int = 16
    max_depth: float = 80.0
    decode_steps: int = 8
    gaze_points: int = 5
    frame_hw: tuple = (180, 320)
    pad_hw: tuple = (196, 336)
    router_bias_std: float = 0.025  # random weights: the correction bias's draw, N(0, std^2)
    balance_target: float = 3.0  # then fitted until the heaviest expert takes at most this over the mean
    balance_step: float = 0.01
    balance_passes: int = 40


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Reserved ids at the top of a vocabulary of ``vocab``: coordinate bins,
    box indices, classes, the two separators and the image placeholder;
    template ids are drawn below ``coord0``."""

    coord0: int
    box0: int
    class0: int
    open: int
    close: int
    image: int

    @classmethod
    def of(cls, vocab: int, max_boxes: int) -> "TokenLayout":
        coord0 = vocab - (COORD_BINS + max_boxes + len(CLASS_COLORS) + 3)
        if coord0 <= 0:
            raise ValueError(f"a vocabulary of {vocab} leaves no room for the labeler's ids")
        box0 = coord0 + COORD_BINS
        class0 = box0 + max_boxes
        sep = class0 + len(CLASS_COLORS)
        return cls(coord0, box0, class0, sep, sep + 1, sep + 2)


@dataclasses.dataclass
class Prompt:
    ids: torch.Tensor  # [T] the worlds' prompts packed
    lengths: list  # each world's prompt length
    boxes: torch.Tensor  # [B, K, 4] the listed boxes, x0 y0 x1 y1 in pixels, clipped to the frame
    count: torch.Tensor  # [B] how many of them each world lists


class VLMLabeler:
    """``label(frames, boxes)``: uint8 frames [B, H, W] and scene boxes [B,
    A, 8] (``scene_boxes``) -> gaze coordinates [B, 2 * gaze_points],
    float32 on the frames' device."""

    def __init__(self, model, cfg: LabelerConfig):
        self.model, self.cfg = model, cfg
        mc = model.cfg
        self.layout = TokenLayout.of(mc.vocab_size, cfg.max_boxes)
        grid = mc.patch_size * mc.merge
        ph, pw = cfg.pad_hw
        if ph % grid or pw % grid or ph < cfg.frame_hw[0] or pw < cfg.frame_hw[1]:
            raise ValueError(f"pad {cfg.pad_hw} must hold the frame and be a multiple of {grid}")
        self.n_image = (ph // grid) * (pw // grid)
        rng = np.random.default_rng(cfg.seed)
        self.template = torch.from_numpy(rng.integers(0, self.layout.coord0, cfg.template_len)).to(
            model.language_model.embed_tokens.weight.device)

    def pixels(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, 3, pad_h, pad_w] in [-1, 1], the padding 0."""
        x = frames.float().div(255.0).sub(0.5).div(0.5)
        ph, pw = self.cfg.pad_hw
        x = F.pad(x, (0, pw - x.shape[-1], 0, ph - x.shape[-2]))
        return x[:, None].expand(-1, 3, -1, -1)

    def prompt(self, boxes: torch.Tensor) -> Prompt:
        cfg, lay = self.cfg, self.layout
        h, w = cfg.frame_hw
        b, a = boxes.shape[:2]
        k = min(cfg.max_boxes, a)
        ok = (boxes[..., 6] > 0.5) & (boxes[..., 4] < cfg.max_depth)
        order = torch.sort(torch.where(ok, boxes[..., 4], float("inf")), dim=1, stable=True).indices[:, :k]
        sel = boxes.gather(1, order[..., None].expand(-1, -1, boxes.shape[-1]))
        count = ok.gather(1, order).sum(1)
        hi = sel.new_tensor([w - 1, h - 1, w - 1, h - 1])
        xyxy = torch.minimum(sel[..., [0, 2, 1, 3]].clamp_min(0.0), hi)
        bins = torch.round(xyxy / hi * (COORD_BINS - 1)).long()
        cls = (sel[..., 5:6] - sel.new_tensor(CLASS_COLORS)).abs().argmin(-1)
        tokens = torch.cat([torch.full_like(cls[..., None], lay.open), lay.class0 + cls[..., None],
                            lay.coord0 + bins, torch.full_like(cls[..., None], lay.close)], -1)
        t = self.template
        image = torch.full((self.n_image,), lay.image, device=t.device, dtype=t.dtype)
        head = torch.cat([t[:cfg.image_at], image, t[cfg.image_at:]])
        rows = torch.cat([head.expand(b, -1), tokens.flatten(1)], 1)
        lengths = (head.shape[0] + 7 * count).tolist()
        keep = torch.arange(rows.shape[1], device=rows.device)[None] < rows.new_tensor(lengths)[:, None]
        return Prompt(rows[keep], lengths, xyxy, count)

    def parse(self, generated: torch.Tensor, prompt: Prompt) -> torch.Tensor:
        """Generated ids [B, steps + 1] -> coordinates [B, 2 * gaze_points]:
        the first distinct picks of listed boxes, their centres."""
        ids, boxes, count = generated.cpu().numpy(), prompt.boxes.cpu().numpy(), prompt.count.cpu().numpy()
        picked = []
        for b, row in enumerate(ids):
            picks = []
            for i in row - self.layout.box0:
                if 0 <= i < count[b] and i not in picks:
                    picks.append(int(i))
                if len(picks) == self.cfg.gaze_points:
                    break
            picked.append(boxes[b, picks])
        coords = bboxes_to_gaze_coords(picked, len(picked), self.cfg.frame_hw, self.cfg.gaze_points)
        return torch.from_numpy(coords).to(generated.device)

    def generate(self, frames: torch.Tensor, prompt: Prompt) -> torch.Tensor:
        """The greedy answer ids [B, decode_steps + 1]."""
        steps = self.cfg.decode_steps
        with span("label.vision"):
            image = self.model.encode_images(self.pixels(frames))
        with span("label.prefill"):
            logits, cache = self.model.prefill(prompt.ids, prompt.lengths, image, self.cfg.image_at, steps)
        out = [logits.argmax(-1)]
        with span("label.decode"):
            for _ in range(steps):
                out.append(self.model.decode(out[-1], cache).argmax(-1))
        return torch.stack(out, 1)

    @torch.inference_mode()
    def balance(self, frames: torch.Tensor, boxes: torch.Tensor) -> list[float]:
        """Fit the routers' correction biases on these frames' prompts
        (``balance_routers`` at the config's target, step and passes).
        Returns each expert layer's heaviest-over-mean load of the last pass."""
        cfg, prompt = self.cfg, self.prompt(boxes)
        image = self.model.encode_images(self.pixels(frames))
        return balance_routers(self.model, lambda: self.model.prefill(prompt.ids, prompt.lengths, image,
                                                                      cfg.image_at, 0),
                               cfg.balance_target, cfg.balance_step, cfg.balance_passes)

    @torch.inference_mode()
    def label(self, frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        prompt = self.prompt(boxes)
        return self.parse(self.generate(frames, prompt), prompt)
