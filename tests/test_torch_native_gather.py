"""Port parity: the native batch gather (gabril_carla_tpu_torch/native,
csrc/gather.cpp) and BCDataset's choice of gather (data/dataset.py).

BCDataset on an in-memory uint8 store gathers through the native library;
its batches are bitwise equal to its numpy loop and to the JAX package's
``BCDataset(use_native=False)`` at tests/test_data.py's indices (episode
edges and front clamps) and at several frame stacks. A lazy HDF5 store
takes the numpy loop. A build with a compiler that does not exist, or one
that fails, raises: nothing falls back to numpy. The wrappers refuse
arrays the C code would misread. A host-path Trainer epoch gives bitwise
the same parameters with either gather. Tolerance: none.
"""

import numpy as np
import pytest
import torch

from gabril_carla_tpu.data import BCDataset as JDataset
from gabril_carla_tpu.data import synthetic_episodes as j_synthetic
from gabril_carla_tpu_torch import native
from gabril_carla_tpu_torch.data.dataset import BCDataset, load_hdf5, synthetic_episodes
from gabril_carla_tpu_torch.train.loop import Trainer
from test_torch_common import BC_A, BC_H, BC_P, BC_S, BC_W, bc_cfgs, cpu_threads

EPISODES = dict(n_demos=3, steps=11, img_hw=(16, 20), max_points=2, seed=3)  # tests/test_data.py:12
IDXS = np.asarray([0, 1, 10, 11, 12, 21, 32])  # episode boundaries + clamps


def assert_batches_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stack", [1, 2, 3, 5])
def test_native_equals_numpy_and_jax(stack):
    ds = BCDataset(synthetic_episodes(**EPISODES), frame_stack=stack)
    assert ds._native is native  # the default on an in-memory uint8 store
    loop = BCDataset(synthetic_episodes(**EPISODES), frame_stack=stack, use_native=False)
    assert loop._native is None
    jax_ds = JDataset(j_synthetic(**EPISODES), frame_stack=stack, use_native=False)
    got = ds.sample(IDXS)
    assert_batches_equal(got, loop.sample(IDXS))
    assert_batches_equal(got, jax_ds.sample(IDXS))
    # every sample of the store, in a shuffled batch
    order = np.random.default_rng(stack).permutation(len(ds))
    assert_batches_equal(ds.sample(order), jax_ds.sample(order))


def test_full_size_frames_and_threads():
    """180x320x3 frames, more samples than threads, one and eight threads."""
    store = synthetic_episodes(n_demos=2, steps=9, seed=1)
    ds = BCDataset(store, frame_stack=2)
    idx = np.arange(len(ds))[::-1].copy()
    want = BCDataset(synthetic_episodes(n_demos=2, steps=9, seed=1), 2, use_native=False).sample(idx)
    assert_batches_equal(ds.sample(idx), want)
    st = ds.store
    pairs = ds._index[idx]
    for threads in (1, 8):
        out = np.zeros((len(idx), 2, 180, 320, 3), np.uint8)
        native.gather_windows_u8(st.flat_images, st.offsets, st.lengths, 180 * 320 * 3,
                                 np.ascontiguousarray(pairs[:, 0]), np.ascontiguousarray(pairs[:, 1]),
                                 2, out, threads=threads)
        np.testing.assert_array_equal(out, want["obs_seq"])


def test_lazy_store_takes_the_numpy_loop(tmp_path):
    import h5py

    store = synthetic_episodes(n_demos=2, steps=7, img_hw=(8, 10), max_points=2, seed=1)
    path = tmp_path / "x.hdf5"
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for i in range(2):
            g = data.create_group(f"demo_{i}")
            og = g.create_group("obs")
            og.create_dataset("image", data=store.images[i])
            og.create_dataset("gaze_coords", data=store.gazes[i])
            g.create_dataset("actions", data=store.actions[i])
    lazy = BCDataset(load_hdf5(str(path), cache_images=False), frame_stack=3)
    eager = BCDataset(load_hdf5(str(path)), frame_stack=3)
    assert lazy.store.lazy and lazy._native is None and eager._native is native
    idx = np.asarray([0, 1, 6, 7, 8, 13])
    assert_batches_equal(lazy.sample(idx), eager.sample(idx))


@pytest.mark.parametrize("cxx, match", [("no-such-compiler-gcc", "not on PATH"),
                                        ("false", "false failed on")])
def test_failed_build_raises(tmp_path, monkeypatch, cxx, match):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", cxx)
    with pytest.raises(RuntimeError, match=match):
        BCDataset(synthetic_episodes(**EPISODES), frame_stack=2)
    assert not list(tmp_path.glob("build/*.so"))
    # asked for the numpy loop, no build is tried
    assert BCDataset(synthetic_episodes(**EPISODES), 2, use_native=False)._native is None


@pytest.mark.parametrize("case", ["dtype", "index dtype", "demo range", "out size", "order"])
def test_wrappers_refuse_what_the_c_code_would_misread(case):
    st = BCDataset(synthetic_episodes(**EPISODES), frame_stack=2).store
    row = 16 * 20 * 3
    d, t = np.zeros(2, np.int64), np.ones(2, np.int64)
    good = np.empty((2, 2, row), np.uint8)
    native.gather_windows_u8(st.flat_images, st.offsets, st.lengths, row, d, t, 2, good)
    base, di, ti, out = {
        "dtype": (st.flat_images.astype(np.int16), d, t, good),
        "index dtype": (st.flat_images, d.astype(np.int32), t, good),
        "demo range": (st.flat_images, np.array([0, 3]), t, good),
        "out size": (st.flat_images, d, t, np.empty((2, 1, row), np.uint8)),
        "order": (st.flat_images, d, t, np.empty((row, 2, 2), np.uint8).transpose(2, 1, 0)),
    }[case]
    with pytest.raises(ValueError):
        native.gather_windows_u8(base, st.offsets, st.lengths, row, di, ti, 2, out)


def test_trainer_epoch_bitwise_with_either_gather(tmp_path):
    """The host-batch path (training.device_data=false): one epoch of four
    steps gives bitwise the same parameters with either gather."""
    params = []
    with cpu_threads(1):
        for use_native in (True, False):
            _, cfg = bc_cfgs("Reg", "None", **{"logging.log_dir": str(tmp_path / str(use_native)),
                                               "training.device_data": False})
            ds = BCDataset(synthetic_episodes(n_demos=2, steps=8, img_hw=(BC_H, BC_W), max_points=BC_P,
                                              action_dim=BC_A, seed=5), BC_S, use_native=use_native)
            trainer = Trainer(cfg, ds, device="cpu")
            assert not trainer.device_mode and trainer.steps_per_epoch == 4
            trainer.train()
            params.append(trainer.state.params)
    assert set(params[0]) == set(params[1])
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
