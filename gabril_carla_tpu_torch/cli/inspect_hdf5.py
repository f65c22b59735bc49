"""HDF5 structure and statistics (port of
gabril_carla_tpu/cli/inspect_hdf5.py; explore_hdf5_data.py /
check_hdf5_structure.py parity, vlm_gaze/data_utils).

    python -m gabril_carla_tpu_torch.cli.inspect_hdf5 --hdf5 FILE [--demos N]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    import h5py

    p = argparse.ArgumentParser()
    p.add_argument("--hdf5", required=True)
    p.add_argument("--demos", type=int, default=3, help="demos to detail")
    args = p.parse_args(argv)

    with h5py.File(args.hdf5, "r") as f:
        demos = sorted(f["data"].keys(), key=lambda s: int(s.split("_")[-1]))
        total = sum(f["data"][d].attrs.get("num_samples", len(f["data"][d]["actions"])) for d in demos)
        print(f"{args.hdf5}: {len(demos)} demos, {total} samples")
        for name in demos[: args.demos]:
            g = f["data"][name]
            print(f"  {name}: num_samples={g.attrs.get('num_samples')}")
            for key in ("obs", "next_obs"):
                if key in g:
                    for k, ds in g[key].items():
                        print(f"    {key}/{k}: {ds.shape} {ds.dtype}")
            for k in ("actions", "rewards", "dones"):
                if k in g:
                    ds = g[k]
                    arr = ds[:]
                    print(f"    {k}: {ds.shape} {ds.dtype} range=[{arr.min():.3f}, {arr.max():.3f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
