"""The confounded dataset: bake action indicators into observations (port
of gabril_carla_tpu/cli/build_confounded.py).

    python -m gabril_carla_tpu_torch.cli.build_confounded --dataset_root DIR --out_root DIR2

Parity with saliency_pipeline/build_confunded_obs.py: overlays a brake dot
and a steering bar (the step's recorded action) onto every frame of an
episode tree, producing the 'confounded' variant used to study causal
confusion (BASELINE.md confounded tables). On ``device``, all frames of an
episode in one batch, one ``confounded_overlay`` call per RGB channel; the
gaze files are copied beside.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.converter import _load_any, _payload, coerce_images
from ..ops.raster import confounded_overlay

EXTRAS = ("gaze", "gaze_pseudo", "filter_dynamic", "non_filter")


def overlay_episode(images: np.ndarray, actions: np.ndarray, device) -> np.ndarray:
    """uint8 [T, H, W, C] frames and [T, 7] actions -> the overlaid uint8
    frames. The frames are scaled to [0, 1] and back as the JAX CLI
    scales them (a true division: a 0-d device divisor, not a host scalar,
    which CUDA would turn into a reciprocal product)."""
    x = torch.from_numpy(images).to(device).float() / torch.tensor(255.0, device=device)
    a = torch.from_numpy(np.asarray(actions, np.float32)).to(device)
    conf = torch.stack([confounded_overlay(x[..., c], a) for c in range(x.shape[-1])], -1)
    return (conf * 255).to(torch.uint8).cpu().numpy()


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--out_root", required=True)
    args = p.parse_args(argv)

    episodes = sorted(p for p in Path(args.dataset_root).glob("route_*/seed_*") if p.is_dir())
    n = 0
    for ep in episodes:
        obs_f, act_f = _payload(ep, "observations"), _payload(ep, "actions")
        if obs_f is None or act_f is None:
            continue
        acts = np.asarray(_load_any(act_f), np.float32)
        conf = overlay_episode(coerce_images(_load_any(obs_f)), acts, device)
        out_ep = Path(args.out_root) / ep.parent.name / ep.name
        out_ep.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out_ep / "observations.npz", observations=conf)
        np.savez_compressed(out_ep / "actions.npz", actions=acts)
        for extra in EXTRAS:
            src = _payload(ep, extra)
            if src is not None and src.suffix == ".npz":
                (out_ep / src.name).write_bytes(src.read_bytes())
        n += 1
        print(f"confounded {ep} -> {out_ep}")
    print(f"done: {n} episodes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
