"""Dataset converter CLI (port of gabril_carla_tpu/cli/convert_dataset.py;
the bench2drive_to_hdf5.py surface, YAML or flags).

    python -m gabril_carla_tpu_torch.cli.convert_dataset --dataset_root DIR --output_hdf5 OUT.hdf5

yaml is imported only with ``--config``, h5py by the conversion itself.
"""

from __future__ import annotations

import argparse

from ..data.converter import convert_episodes


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="YAML with converter keys")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--output_hdf5", default=None)
    p.add_argument("--max_gaze_points", type=int, default=5)
    p.add_argument("--action_dim", type=int, default=7)
    p.add_argument("--compression", default="lzf")
    p.add_argument("--chunk_len", type=int, default=256)
    p.add_argument("--limit_episodes", type=int, default=None)
    args = p.parse_args(argv)

    kw = dict(
        max_gaze_points=args.max_gaze_points,
        action_dim=args.action_dim,
        compression=None if args.compression in ("null", "none", "") else args.compression,
        chunk_len=args.chunk_len,
        limit_episodes=args.limit_episodes,
    )
    root, out = args.dataset_root, args.output_hdf5
    if args.config:
        import yaml

        with open(args.config) as f:
            conf = yaml.safe_load(f)
        root = root or conf.get("dataset_root")
        out = out or conf.get("output_hdf5")
        for k in kw:
            if k in conf:
                kw[k] = conf[k]
    n = convert_episodes(root, out, **kw)
    print(f"wrote {n} demos to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
