"""Port parity for the data tools: data/converter.py, cli/convert_dataset.py,
data/dataset.py's load_hdf5 (eager and lazy), cli/inspect_hdf5.py, and
train_bc on ``data.hdf5_path``.

Both packages convert the same episode directories, whose payloads take
every coercion path (uint8 and float TCHW frames, .npz/.npy/.pt files, gaze
as point lists in pixels, [T, P, 2] arrays and [T, P, 4] boxes, an episode
without gaze, a directory without actions): the HDF5 files must hold equal
datasets and attributes. Each package's load_hdf5 reads them into equal
stores, its CLI prints the same inspection.
"""

import contextlib
import io
import json

import h5py
import numpy as np
import pytest
import torch

from gabril_carla_tpu.cli import inspect_hdf5 as jax_inspect
from gabril_carla_tpu.data import BCDataset as JaxDataset
from gabril_carla_tpu.data import converter as JC
from gabril_carla_tpu.data.dataset import load_hdf5 as jax_load
from gabril_carla_tpu_torch.cli import convert_dataset, inspect_hdf5, train_bc
from gabril_carla_tpu_torch.data import converter as PC
from gabril_carla_tpu_torch.data.dataset import BCDataset, load_hdf5
from test_torch_common import cpu_threads

H, W, T = 24, 48, 9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def make_episodes(root):
    """Four episode dirs covering the payload kinds, and one without actions."""
    rng = np.random.default_rng(0)

    def ep(route, seed):
        d = root / f"route_{route}" / f"seed_{seed}"
        d.mkdir(parents=True)
        return d

    d = ep(1, 0)  # uint8 frames, pixel point lists, boxes
    np.savez_compressed(d / "observations.npz", observations=rng.integers(0, 256, (T, H, W, 3), np.uint8))
    np.savez_compressed(d / "actions.npz", actions=rng.standard_normal((T, 9)).astype(np.float32))
    torch.save([[(5.0, 7.0), (40.0, 20.0)] if t % 3 else [] for t in range(T)], d / "gaze.pt")
    boxes = rng.uniform(0, 20, (T, 2, 4)).astype(np.float32)
    boxes[:, 1] = -1
    np.save(d / "gaze_pseudo.npy", boxes)
    d = ep(1, 1)  # float TCHW frames in [0, 1], normalized [T, P, 2] gaze
    np.save(d / "observations.npy", rng.random((T, 3, H, W), np.float32))
    np.save(d / "actions.npy", rng.standard_normal((T, 7)).astype(np.float32))
    np.savez_compressed(d / "gaze.npz", gaze=rng.random((T, 3, 2), np.float32))
    np.save(d / "non_filter.npy", rng.random((T, 10), np.float32))
    d = ep(2, 5)  # torch payloads, no gaze at all
    torch.save(torch.from_numpy(rng.integers(0, 256, (T, H, W, 3), np.uint8)), d / "observations.pt")
    torch.save(torch.randn(T, 7, generator=torch.Generator().manual_seed(0)), d / "actions.pt")
    d = ep(3, 0)  # float frames in [0, 255], filter_dynamic in pixels
    np.save(d / "observations.npy", rng.uniform(0, 255, (T, H, W, 3)).astype(np.float32))
    np.save(d / "actions.npy", rng.standard_normal((T, 7)).astype(np.float32))
    np.save(d / "filter_dynamic.npy", rng.uniform(0, 40, (T, 2, 2)).astype(np.float32))
    d = ep(4, 0)  # no actions: skipped
    np.save(d / "observations.npy", rng.integers(0, 256, (T, H, W, 3), np.uint8))


def h5_tree(path) -> dict:
    """{name: (array, attrs)} of every dataset and group in an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = (None, dict(f.attrs))

        def visit(name, obj):
            attrs = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in obj.attrs.items()}
            out[name] = (obj[()] if isinstance(obj, h5py.Dataset) else None, attrs)
        f.visititems(visit)
    return out


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("eps")
    make_episodes(root)
    jax_out, port_out = root.parent / "jax.hdf5", root.parent / "port.hdf5"
    assert JC.convert_episodes(root, jax_out) == 4
    conf = root.parent / "conv.yaml"
    conf.write_text(f"dataset_root: {root}\noutput_hdf5: {port_out}\nchunk_len: 256\n")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert convert_dataset.main(["--config", str(conf)]) == 0
    assert "wrote 4 demos" in out.getvalue()
    return root, jax_out, port_out


def test_convert_matches_jax(converted):
    _, jax_out, port_out = converted
    want, got = h5_tree(jax_out), h5_tree(port_out)
    assert set(got) == set(want)
    for name, (arr, attrs) in want.items():
        assert got[name][1] == attrs, name
        if arr is None:
            assert got[name][0] is None, name
        else:
            assert got[name][0].dtype == arr.dtype and np.array_equal(got[name][0], arr), name
    assert json.loads(want["/"][1]["env_args"])["env_name"] == "bench2drive_tpu"


@pytest.mark.parametrize("key", ["gaze_coords", "gaze_coords_gaze_pseudo"])
@pytest.mark.parametrize("cache_images", [True, False])
def test_load_hdf5_matches_jax(converted, key, cache_images):
    _, path, _ = converted
    want = jax_load(str(path), gaze_key=key, demo_limit=3, cache_images=cache_images)
    got = load_hdf5(str(path), gaze_key=key, demo_limit=3, cache_images=cache_images)
    assert got.n_demos == want.n_demos == 3 and got.lazy == want.lazy == (not cache_images)
    for a, b in zip(got.gazes + got.actions, want.gazes + want.actions):
        np.testing.assert_array_equal(a, b)
    idxs = np.asarray([0, 1, 8, 9, 10, 26])
    np.testing.assert_array_equal(len(BCDataset(got, 2)), len(JaxDataset(want, 2, use_native=False)))
    a = BCDataset(got, frame_stack=2).sample(idxs)
    b = JaxDataset(want, frame_stack=2, use_native=False).sample(idxs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.offsets.tolist() == [0, T, 2 * T]


def test_load_episodes_matches_hdf5(converted):
    """converter.load_episodes (no HDF5) gives load_hdf5's store."""
    root, path, _ = converted
    direct = PC.load_episodes(root, gaze_key="gaze_coords_non_filter")
    via = load_hdf5(str(path), gaze_key="gaze_coords_non_filter")
    assert direct.n_demos == via.n_demos == 4
    for a, b in zip(direct.images + direct.gazes + direct.actions, via.images + via.gazes + via.actions):
        np.testing.assert_array_equal(a, b)


def test_inspect_matches_jax(converted):
    _, path, _ = converted
    outs = []
    for mod in (jax_inspect, inspect_hdf5):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert mod.main(["--hdf5", str(path), "--demos", "4"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "4 demos, 36 samples" in outs[1]


def test_coercions_match_jax():
    rng = np.random.default_rng(3)
    frames = rng.random((4, 3, 6, 8)).astype(np.float32)
    np.testing.assert_array_equal(PC.coerce_images(frames), JC.coerce_images(frames))
    boxes = rng.uniform(0, 9, (3, 2, 4)).astype(np.float32)
    for raw in ([b for b in boxes], boxes, None, {"gaze": boxes[..., :2]}):
        np.testing.assert_array_equal(PC.coerce_gaze(raw, 3, (10, 20), 3), JC.coerce_gaze(raw, 3, (10, 20), 3))
    assert PC.GAZE_VARIANTS == JC.GAZE_VARIANTS and PC.LEGACY_ALIAS == JC.LEGACY_ALIAS


@pytest.mark.parametrize("lazy", [False, True])
def test_train_bc_on_hdf5(converted, tmp_path, lazy):
    """train_bc with data.hdf5_path runs one epoch (device data 'auto': on
    for the in-memory store, off for a lazy one)."""
    _, path, _ = converted
    args = ["data.img_height=24", "data.img_width=48", "data.batch_size=8", "model.embedding_dim=8",
            "model.num_hiddens=16", "model.num_residual_layers=1", "model.num_residual_hiddens=8",
            "model.z_dim=16", "gaze.method=Reg", "gaze.max_points=5", "gaze.mask_sigma=4.0",
            "training.compute_dtype=float32", "training.epochs=1", f"data.hdf5_path={path}",
            "data.gaze_key=gaze_coords_gaze", "data.num_episodes=3", f"logging.log_dir={tmp_path}"]
    if lazy:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train_bc, "load_hdf5", lambda p, **kw: load_hdf5(p, cache_images=False, **kw))
            assert train_bc.main(args, device="cpu") == 0
    else:
        assert train_bc.main(args, device="cpu") == 0
    assert next(tmp_path.glob("*/*/checkpoints/ep1/params.pt")).exists()
