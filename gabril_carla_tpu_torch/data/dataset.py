"""BC dataset, host side (port of gabril_carla_tpu/data/dataset.py: the
episode store, HDF5 loading, the synthetic episodes and the batch gather).

Schema (vlm_gaze/data_utils/bench2drive_to_hdf5.py:21-56): per episode
images [T, H, W, 3] uint8, gaze [T, P*2] float32 in [0, 1] with -1 padding,
actions [T, A] float32. Sampling (robomimic SequenceDataset, seq_length=1,
frame_stack=S, front padding): one sample per timestep t, the window
[t-S+1 .. t] clamped to the episode start.

Batches are numpy dicts; heatmaps, grayscale and stacking run on the device
inside the train step. ``load_hdf5`` imports h5py only when it is called.
In-memory uint8 stores gather their batches with the threaded native
library (native/: g++ at first use); lazy stores, whose images stay on
disk, take the numpy loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class EpisodeStore:
    """In-memory episode arrays. ``finalize()`` packs the episodes into flat
    buffers (one per stream); per-episode views stay available."""

    images: list[np.ndarray] = field(default_factory=list)  # each [T,H,W,3] uint8
    gazes: list[np.ndarray] = field(default_factory=list)  # each [T,P*2] f32
    actions: list[np.ndarray] = field(default_factory=list)  # each [T,A] f32
    flat_images: np.ndarray | None = None
    flat_gazes: np.ndarray | None = None
    flat_actions: np.ndarray | None = None
    offsets: np.ndarray | None = None  # [D] start row per demo
    lengths: np.ndarray | None = None  # [D]

    def add(self, images: np.ndarray, gazes: np.ndarray, actions: np.ndarray):
        t = len(images)
        if len(gazes) != t or len(actions) != t:
            raise ValueError("episode stream lengths differ")
        self.images.append(np.ascontiguousarray(images))
        self.gazes.append(np.ascontiguousarray(gazes, dtype=np.float32))
        self.actions.append(np.ascontiguousarray(actions, dtype=np.float32))
        self.flat_images = None  # invalidate

    def finalize(self) -> "EpisodeStore":
        if self.lazy:  # images stay on disk: offsets only, no flat buffers
            if self.lengths is None and self.images:
                self.lengths = np.asarray([len(x) for x in self.images], np.int64)
                self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)
            return self
        if self.flat_images is None and self.images:
            self.lengths = np.asarray([len(x) for x in self.images], np.int64)
            self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)
            self.flat_images = np.concatenate(self.images, axis=0)
            self.flat_gazes = np.concatenate(self.gazes, axis=0)
            self.flat_actions = np.concatenate(self.actions, axis=0)
            # re-point per-episode arrays at views into the flat buffers
            bounds = np.cumsum(self.lengths)[:-1]
            self.images = np.split(self.flat_images, bounds)
            self.gazes = np.split(self.flat_gazes, bounds)
            self.actions = np.split(self.flat_actions, bounds)
        return self

    @property
    def n_demos(self) -> int:
        return len(self.images)

    @property
    def lazy(self) -> bool:
        return bool(self.images) and not isinstance(self.images[0], np.ndarray)


class _LazyImages:
    """On-demand image reads from an open HDF5 dataset (robomimic cache
    mode 'low_dim'/None parity: low-dim streams in RAM, images on disk)."""

    def __init__(self, file, key: str):
        self._file = file  # keep the h5py.File alive
        self._ds = file[key]
        self.shape = self._ds.shape
        self.dtype = self._ds.dtype
        self.nbytes = int(np.prod(self.shape)) * self._ds.dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        if idx.ndim == 0:
            return self._ds[int(idx)]
        # h5py fancy selection needs increasing unique indices; windows are
        # clamped (duplicated) at episode starts, so read the span and index
        lo, hi = int(idx.min()), int(idx.max()) + 1
        return self._ds[lo:hi][idx - lo]


def _demo_names(f, demo_limit):
    demos = sorted(f["data"].keys(), key=lambda s: int(s.split("_")[-1]))
    return demos if demo_limit is None else demos[:demo_limit]


def load_hdf5(path: str, gaze_key: str = "gaze_coords", demo_limit: int | None = None,
              cache_images: bool = True) -> EpisodeStore:
    """Read a robomimic-schema HDF5 into an EpisodeStore.

    ``cache_images=False`` keeps the images on disk and reads windows on
    demand (SequenceDataset hdf5_cache_mode low_dim/None,
    robomimic/utils/dataset.py:218-219): gaze and actions load eagerly, the
    images become lazy per-demo views over an open SWMR handle. A lazy
    store has no flat buffers, so training cannot hold it on the device.
    """
    import h5py

    store = EpisodeStore()
    if cache_images:
        with h5py.File(path, "r", swmr=True, libver="latest") as f:
            for name in _demo_names(f, demo_limit):
                g = f["data"][name]
                store.add(np.asarray(g["obs"]["image"][:]), g["obs"][gaze_key][:], g["actions"][:])
        return store
    f = h5py.File(path, "r", swmr=True, libver="latest")  # held open by the views
    for name in _demo_names(f, demo_limit):
        g = f["data"][name]
        store.images.append(_LazyImages(f, f"data/{name}/obs/image"))
        store.gazes.append(np.ascontiguousarray(g["obs"][gaze_key][:], dtype=np.float32))
        store.actions.append(np.ascontiguousarray(g["actions"][:], dtype=np.float32))
    return store


def synthetic_episodes(
    n_demos: int = 4,
    steps: int = 64,
    img_hw: tuple[int, int] = (180, 320),
    max_points: int = 5,
    action_dim: int = 7,
    seed: int = 0,
) -> EpisodeStore:
    """Random episodes with the real schema, for tests and benches (the JAX
    package's, value for value, from the same numpy seed)."""
    rng = np.random.default_rng(seed)
    store = EpisodeStore()
    h, w = img_hw
    for _ in range(n_demos):
        imgs = rng.integers(0, 256, (steps, h, w, 3), dtype=np.uint8)
        gaze = rng.random((steps, max_points * 2)).astype(np.float32)
        invalid = rng.random((steps, max_points)) < 0.3
        gaze = gaze.reshape(steps, max_points, 2)
        gaze[invalid] = -1.0
        gaze = gaze.reshape(steps, max_points * 2)
        acts = rng.standard_normal((steps, action_dim)).astype(np.float32)
        store.add(imgs, gaze, acts)
    return store


class BCDataset:
    """Windowed BC sampler over an EpisodeStore. In-memory uint8 stores
    assemble batches with the native threaded-memcpy library (native/; a
    failed build raises); lazy stores and ``use_native=False`` take the
    numpy loop."""

    def __init__(self, store: EpisodeStore, frame_stack: int = 2, use_native: bool = True):
        self.store = store.finalize()
        self.frame_stack = int(frame_stack)
        # flat (demo, t) index with front padding (every t is a sample)
        self._index = np.array(
            [(d, t) for d in range(store.n_demos) for t in range(len(store.images[d]))],
            dtype=np.int64,
        )
        self._native = None
        if use_native and not store.lazy and store.images and store.images[0].dtype == np.uint8:
            from .. import native

            native.load()
            self._native = native

    def __len__(self) -> int:
        return len(self._index)

    @property
    def n_demos(self) -> int:
        return self.store.n_demos

    def _window(self, demo: int, t: int) -> np.ndarray:
        start = t - (self.frame_stack - 1)
        return np.clip(np.arange(start, t + 1), 0, len(self.store.images[demo]) - 1)

    def sample(self, idxs: np.ndarray) -> dict:
        s = self.frame_stack
        n = len(idxs)
        st = self.store
        img0 = st.images[0]
        obs = np.empty((n, s, *img0.shape[1:]), dtype=img0.dtype)
        gaze = np.empty((n, s, st.gazes[0].shape[-1]), dtype=np.float32)
        acts = np.empty((n, st.actions[0].shape[-1]), dtype=np.float32)
        pairs = self._index[np.asarray(idxs)]
        demo_idx = np.ascontiguousarray(pairs[:, 0])
        t_idx = np.ascontiguousarray(pairs[:, 1])

        if self._native is not None:
            row = int(np.prod(img0.shape[1:]))
            self._native.gather_windows_u8(st.flat_images, st.offsets, st.lengths, row,
                                           demo_idx, t_idx, s, obs)
            self._native.gather_windows_f32(st.flat_gazes, st.offsets, st.lengths,
                                            st.flat_gazes.shape[-1], demo_idx, t_idx, s, gaze)
            self._native.gather_rows_f32(st.flat_actions, st.offsets, st.lengths,
                                         st.flat_actions.shape[-1], demo_idx, t_idx, acts)
            return {"obs_seq": obs, "gaze_seq": gaze, "actions": acts}

        for i in range(n):
            d, t = demo_idx[i], t_idx[i]
            win = self._window(d, t)
            obs[i] = st.images[d][win]
            gaze[i] = st.gazes[d][win]
            acts[i] = st.actions[d][t]
        return {"obs_seq": obs, "gaze_seq": gaze, "actions": acts}

    def iter_batches(self, batch_size: int, rng: np.random.Generator, drop_last: bool = True):
        order = rng.permutation(len(self))
        nb = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        for b in range(nb):
            yield self.sample(order[b * batch_size : (b + 1) * batch_size])

    def steps_per_epoch(self, batch_size: int, drop_last: bool = True) -> int:
        return len(self) // batch_size if drop_last else -(-len(self) // batch_size)
