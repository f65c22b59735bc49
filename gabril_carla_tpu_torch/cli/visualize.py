"""Dataset visualization: 3-panel (image | gaze heatmap | overlay) GIFs (port
of gabril_carla_tpu/cli/visualize.py).

    python -m gabril_carla_tpu_torch.cli.visualize --hdf5 data.hdf5 --demo 0 --out viz.gif

Parity with train_data_viz.py (vlm_gaze/data_utils/train_data_viz.py: GIF of
image/heatmap/overlay triptychs from HDF5 through the GazePreprocessor) and
plot_gaze_and_obs (data_utils/utils.py:71-113). The heat runs on the card
(``panels``); h5py and PIL are imported only by ``main``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def triptych(image_u8: np.ndarray, heat: np.ndarray) -> np.ndarray:
    """[H,W,3] uint8 + [H,W] float -> side-by-side panel [H, 3W, 3] uint8."""
    img = image_u8.astype(np.float32) / 255.0
    h3 = np.stack([heat] * 3, -1)
    overlay = img * h3
    panel = np.concatenate([img, h3, overlay], axis=1)
    return (np.clip(panel, 0, 1) * 255).astype(np.uint8)


def panels(images: np.ndarray, gaze: np.ndarray, sigma: float = 30.0,
           device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Frames [T, H, W, 3] uint8 and gaze [T, P*2] -> (the gaze heatmaps
    [T, H, W] float32, computed on ``device``; the triptychs [T, H, 3W, 3]
    uint8)."""
    from ..ops.heatmap import GazeHeatmapper

    h, w = images.shape[1:3]
    hm = GazeHeatmapper(img_height=h, img_width=w, gaze_sigma=sigma, maxpoints=gaze.shape[-1] // 2)
    heat = hm.heatmaps(torch.from_numpy(np.asarray(gaze, np.float32)).to(device)).cpu().numpy()
    return heat, np.stack([triptych(images[i], heat[i]) for i in range(len(images))])


def main(argv=None, device="cuda"):
    from ..data.dataset import load_hdf5

    p = argparse.ArgumentParser()
    p.add_argument("--hdf5", required=True)
    p.add_argument("--demo", type=int, default=0)
    p.add_argument("--gaze_key", default="gaze_coords")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--sigma", type=float, default=30.0)
    p.add_argument("--out", default="viz.gif")
    args = p.parse_args(argv)

    store = load_hdf5(args.hdf5, gaze_key=args.gaze_key, demo_limit=args.demo + 1)
    imgs = store.images[args.demo][: args.frames * args.stride : args.stride]
    gaze = store.gazes[args.demo][: args.frames * args.stride : args.stride]
    _, tri = panels(imgs, gaze, args.sigma, device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    frames = [Image.fromarray(t) for t in tri]
    frames[0].save(out, save_all=True, append_images=frames[1:], duration=100, loop=0)
    print(f"wrote {len(frames)}-frame GIF to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
