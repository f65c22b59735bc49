"""Episode directories -> robomimic-schema HDF5 (port of
gabril_carla_tpu/data/converter.py; the reference's
vlm_gaze/data_utils/bench2drive_to_hdf5.py).

Walks <root>/route_*/seed_*/ episode dirs, coerces observations to uint8
[T, H, W, 3], normalizes the gaze variants to [T, max_points*2] float32 with
-1 padding (pixel -> [0, 1] autodetection, box -> center for [P, 4] boxes),
and writes data/demo_i/{obs,next_obs,actions,rewards,dones} with chunked
compression. Payloads are .npz, .npy or torch .pt. h5py is imported only by
``convert_episodes``; ``load_episodes`` reads the same episodes through the
same coercions straight into an EpisodeStore, without HDF5.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .dataset import EpisodeStore

GAZE_VARIANTS = {
    "gaze": "gaze_coords_gaze",
    "gaze_pseudo": "gaze_coords_gaze_pseudo",
    "filter_dynamic": "gaze_coords_filter_dynamic",
    "non_filter": "gaze_coords_non_filter",
}
LEGACY_ALIAS = "gaze_coords"
SUFFIXES = (".npz", ".npy", ".pt")


def _load_any(path: Path):
    """Load .npz/.npy/.pt episode payloads into numpy."""
    if path.suffix == ".npz":
        z = np.load(path, allow_pickle=True)
        return {k: z[k] for k in z.files} if len(z.files) > 1 else z[z.files[0]]
    if path.suffix == ".npy":
        return np.load(path, allow_pickle=True)
    if path.suffix == ".pt":
        import torch

        return _torch_to_numpy(torch.load(path, map_location="cpu", weights_only=False))
    raise ValueError(f"unsupported episode payload: {path}")


def _torch_to_numpy(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _torch_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_torch_to_numpy(v) for v in obj]
    return obj


def coerce_images(obs) -> np.ndarray:
    """-> uint8 [T, H, W, 3] (converter :188-263 semantics)."""
    if isinstance(obs, dict):
        obs = obs.get("observations", obs.get("obs", next(iter(obs.values()))))
    arr = np.asarray(obs)
    if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (0, 2, 3, 1))  # TCHW -> THWC
    if arr.dtype != np.uint8:
        mx = float(arr.max()) if arr.size else 1.0
        arr = (arr * 255.0).clip(0, 255).astype(np.uint8) if mx <= 1.5 else arr.clip(0, 255).astype(np.uint8)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"bad image shape {arr.shape}")
    return arr


def coerce_gaze(raw, t: int, hw: tuple[int, int], max_points: int = 5) -> np.ndarray:
    """-> float32 [T, max_points*2], coords in [0,1], -1 fill (:269-363).

    Accepts per-step lists of points, [T,P,2] arrays, [T,P,4] boxes
    (converted to centers), pixel or normalized coordinates.
    """
    h, w = hw
    out = np.full((t, max_points, 2), -1.0, dtype=np.float32)
    if raw is None:
        return out.reshape(t, max_points * 2)
    if isinstance(raw, dict):
        raw = raw.get("gaze", next(iter(raw.values())))

    def put(i, pts, pts_dim):
        pts = np.asarray(pts, dtype=np.float32).reshape(-1, pts_dim)
        if pts_dim == 4:  # bbox -> center
            pts = np.stack([(pts[:, 0] + pts[:, 2]) / 2, (pts[:, 1] + pts[:, 3]) / 2], 1)
        valid = pts[(pts[:, 0] >= 0) & (pts[:, 1] >= 0)][:max_points]
        if len(valid) and valid.max() > 1.5:  # pixel coords -> [0,1]
            valid = valid / np.asarray([w - 1, h - 1], dtype=np.float32)
        out[i, : len(valid)] = np.clip(valid, 0.0, 1.0)

    if isinstance(raw, (list, tuple)):
        for i, step in enumerate(raw[:t]):
            if step is None or (hasattr(step, "__len__") and len(step) == 0):
                continue
            step_arr = np.asarray(step, dtype=np.float32)
            put(i, step_arr, 4 if (step_arr.ndim == 2 and step_arr.shape[-1] == 4) else 2)
    else:
        arr = np.asarray(raw, dtype=np.float32)
        if arr.ndim == 2 and arr.shape[-1] in (2, max_points * 2):
            arr = arr.reshape(t, -1, 2) if arr.shape[-1] != 2 else arr[:, None, :]
        pts_dim = arr.shape[-1] if arr.ndim == 3 else 2
        for i in range(min(t, len(arr))):
            put(i, arr[i], pts_dim)
    return out.reshape(t, max_points * 2)


def _payload(ep: Path, stem: str) -> Path | None:
    return next((ep / f"{stem}{s}" for s in SUFFIXES if (ep / f"{stem}{s}").exists()), None)


def episode_dirs(dataset_root, limit_episodes: int | None = None,
                 include_routes: list[str] | None = None) -> list[Path]:
    """The route_*/seed_* episode directories under ``dataset_root``, sorted."""
    episodes = sorted(p for p in Path(dataset_root).glob("route_*/seed_*") if p.is_dir()
                      and (not include_routes or p.parent.name in include_routes))
    return episodes[:limit_episodes] if limit_episodes else episodes


def read_episode(ep: Path, max_gaze_points: int = 5, action_dim: int = 7) -> dict | None:
    """One episode directory through the coercions: {"images", "actions",
    "gaze": {dataset key: coords}} with every GAZE_VARIANTS key and
    LEGACY_ALIAS (the "gaze" variant's coords when that payload exists,
    else all -1), or None without observations or actions."""
    obs_file, act_file = _payload(ep, "observations"), _payload(ep, "actions")
    if obs_file is None or act_file is None:
        return None
    images = coerce_images(_load_any(obs_file))
    t = len(images)
    actions = np.asarray(_load_any(act_file), dtype=np.float32).reshape(t, -1)[:, :action_dim]
    gaze = {}
    legacy = None
    for stem, key in GAZE_VARIANTS.items():
        src = _payload(ep, stem)
        gaze[key] = coerce_gaze(_load_any(src) if src else None, t, images.shape[1:3], max_gaze_points)
        if stem == "gaze" and src is not None:
            legacy = gaze[key]
    gaze[LEGACY_ALIAS] = legacy if legacy is not None else np.full(
        (t, max_gaze_points * 2), -1.0, np.float32)
    return {"images": images, "actions": actions, "gaze": gaze}


def _next(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a[1:], a[-1:]], axis=0)


def convert_episodes(
    dataset_root: str | Path,
    output_hdf5: str | Path,
    max_gaze_points: int = 5,
    action_dim: int = 7,
    compression: str | None = "lzf",
    chunk_len: int = 256,
    limit_episodes: int | None = None,
    include_routes: list[str] | None = None,
) -> int:
    """Walk route_*/seed_* episode dirs, emit one robomimic HDF5. Returns #demos."""
    import h5py

    out = Path(output_hdf5)
    out.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with h5py.File(out, "w") as f:
        data = f.create_group("data")
        total = 0
        for ep in episode_dirs(dataset_root, limit_episodes, include_routes):
            rec = read_episode(ep, max_gaze_points, action_dim)
            if rec is None:
                continue
            images = rec["images"]
            t = len(images)
            g = data.create_group(f"demo_{n}")
            g.attrs["num_samples"] = t
            chunk = (min(chunk_len, t), *images.shape[1:])
            obs_g, next_g = g.create_group("obs"), g.create_group("next_obs")
            obs_g.create_dataset("image", data=images, chunks=chunk, compression=compression)
            next_g.create_dataset("image", data=_next(images), chunks=chunk, compression=compression)
            for key, coords in rec["gaze"].items():
                obs_g.create_dataset(key, data=coords)
                next_g.create_dataset(key, data=_next(coords))
            g.create_dataset("actions", data=rec["actions"])
            g.create_dataset("rewards", data=np.zeros((t, 1), np.float32))
            dones = np.zeros((t, 1), np.float32)
            dones[-1] = 1.0
            g.create_dataset("dones", data=dones)
            total += t
            n += 1
        data.attrs["total"] = total
        f.attrs["env_args"] = json.dumps({"env_name": "bench2drive_tpu", "type": 1})
    return n


def load_episodes(dataset_root, gaze_key: str = LEGACY_ALIAS, max_gaze_points: int = 5,
                  action_dim: int = 7, limit_episodes: int | None = None) -> EpisodeStore:
    """The episodes under ``dataset_root`` as convert_episodes + load_hdf5
    would give them, without HDF5 (h5py is not needed)."""
    store = EpisodeStore()
    for ep in episode_dirs(dataset_root, limit_episodes):
        rec = read_episode(ep, max_gaze_points, action_dim)
        if rec is not None:
            store.add(rec["images"], rec["gaze"][gaze_key], rec["actions"])
    return store
