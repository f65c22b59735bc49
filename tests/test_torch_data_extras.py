"""Port parity for the data tools: saliency/pseudo_gaze.py,
cli/build_confounded.py and eval/video.py.

* ``scene_boxes`` against JAX's ops/raster._collect_actor_boxes on the 20
  real routes at reset (1e-5 relative), then ``SceneGraphDetector`` (all
  actors and dynamic only) and ``generate_pseudo_gaze`` on the same recorded
  boxes (the 20 routes' boxes as 20 frames) through both packages: the
  detections and the written gaze_pseudo.npz bitwise equal;
  ``ExternalVLMDetector`` raises without a callable and adapts one.
* ``build_confounded`` on synthetic episode trees through both CLIs: the
  overlaid observations bitwise equal, the actions and the .npz gaze extras
  copied as JAX copies them.
* ``write_mp4``: tests/test_video.py's two round trips.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gabril_carla_tpu.saliency.pseudo_gaze as JPG
import gabril_carla_tpu_torch.saliency.pseudo_gaze as PPG
from gabril_carla_tpu.cli import build_confounded as jax_build_confounded
from gabril_carla_tpu.data.tasks import seen_routes, unseen_routes
from gabril_carla_tpu.env.env import DrivingEnv
from gabril_carla_tpu.env.world import load_benchmark_specs
from gabril_carla_tpu.ops.raster import _camera_basis, _collect_actor_boxes
from gabril_carla_tpu_torch.cli import build_confounded
from gabril_carla_tpu_torch.env.constants import N_STATICS, N_VEHICLES, N_WALKERS
from gabril_carla_tpu_torch.eval.video import write_mp4
from test_torch_common import cpu_threads, port_state

HW = (180, 320)
# the box rows' pools, in _collect_actor_boxes' order: vehicles, statics, walkers
DYNAMIC = np.concatenate([np.ones(N_VEHICLES, bool), np.zeros(N_STATICS, bool),
                          np.ones(N_WALKERS, bool)])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


@functools.lru_cache(maxsize=None)
def reset_states():
    specs = jax.tree.map(jnp.asarray, load_benchmark_specs(None, seen_routes() + unseen_routes()))
    keys = jax.random.split(jax.random.PRNGKey(11), 20)
    return jax.jit(jax.vmap(DrivingEnv().reset))(specs, keys)


@functools.lru_cache(maxsize=None)
def jax_boxes() -> np.ndarray:
    def one(st):
        return _collect_actor_boxes(st, *_camera_basis(st.ego.pos, st.ego.yaw))

    return np.asarray(jax.vmap(one)(reset_states()))


def test_scene_boxes_match_jax():
    want = jax_boxes()
    got = PPG.scene_boxes(port_state(reset_states())).numpy()
    assert got.shape == want.shape == (20, N_VEHICLES + N_STATICS + N_WALKERS, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (want[:, :, 6] > 0.5).sum() > 20  # actors in view to detect


@pytest.mark.parametrize("dynamic_only", [False, True])
def test_scene_graph_detector_and_pseudo_gaze_match_jax(tmp_path, dynamic_only):
    boxes = jax_boxes()
    kw = dict(dynamic_cols=DYNAMIC, dynamic_only=dynamic_only)
    want_det, got_det = JPG.SceneGraphDetector(boxes, **kw), PPG.SceneGraphDetector(boxes, **kw)
    for i in range(len(boxes)):
        np.testing.assert_array_equal(got_det(i), want_det(i))
    (tmp_path / "jax").mkdir(), (tmp_path / "port").mkdir()
    want = JPG.generate_pseudo_gaze(tmp_path / "jax", want_det, len(boxes), HW)
    got = PPG.generate_pseudo_gaze(tmp_path / "port", got_det, len(boxes), HW)
    assert got.name == want.name == "gaze_pseudo.npz"
    g, w = np.load(got)["gaze"], np.load(want)["gaze"]
    assert g.shape == (20, 10) and g.dtype == np.float32
    np.testing.assert_array_equal(g, w)
    assert (g[:, 0] >= 0).any()


def test_external_vlm_detector():
    frames = np.zeros((3, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="detection callable"):
        PPG.ExternalVLMDetector(None, frames)
    fn = lambda frame: [[1, 2, 5, 6], [0, 0, 3, 3]]  # noqa: E731
    np.testing.assert_array_equal(PPG.ExternalVLMDetector(fn, frames)(1),
                                  JPG.ExternalVLMDetector(fn, frames)(1))


def write_episodes(root: Path):
    """Two episode directories with uint8 RGB frames, actions (brake on
    every third step, steer past both clamps) and gaze extras."""
    rng = np.random.default_rng(4)
    for i, (route, seed, t) in enumerate([(1, 200, 7), (2, 5, 4)]):
        ep = root / f"route_{route}" / f"seed_{seed}"
        ep.mkdir(parents=True)
        acts = rng.standard_normal((t, 7)).astype(np.float32)
        acts[:, 1] = np.linspace(-1.4, 1.4, t)
        acts[::3, 2] = 0.95
        np.savez_compressed(ep / "observations.npz",
                            observations=rng.integers(0, 256, (t, *HW, 3), dtype=np.uint8))
        np.savez_compressed(ep / "actions.npz", actions=acts)
        np.savez_compressed(ep / "gaze.npz", gaze=rng.random((t, 10)).astype(np.float32))
        if i == 0:
            np.savez_compressed(ep / "gaze_pseudo.npz", gaze=rng.random((t, 10)).astype(np.float32))
            np.save(ep / "non_filter.npy", np.zeros((t, 10), np.float32))  # not an .npz: skipped


def test_build_confounded_matches_jax(tmp_path):
    src = tmp_path / "src"
    write_episodes(src)
    assert jax_build_confounded.main(["--dataset_root", str(src),
                                      "--out_root", str(tmp_path / "jax")]) == 0
    assert build_confounded.main(["--dataset_root", str(src), "--out_root",
                                  str(tmp_path / "port")], device="cpu") == 0
    want_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.np*"))
    got_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.np*"))
    assert got_files == want_files and len(want_files) == 7
    for rel in want_files:
        want, got = np.load(tmp_path / "jax" / rel), np.load(tmp_path / "port" / rel)
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, (rel, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rel}:{k}")
        if rel.name.startswith("gaze"):  # copied byte for byte
            assert (tmp_path / "port" / rel).read_bytes() == (src / rel).read_bytes()
    obs = np.load(tmp_path / "port" / "route_1/seed_200/observations.npz")["observations"]
    orig = np.load(src / "route_1/seed_200/observations.npz")["observations"]
    assert (obs != orig).any() and (obs[0] == 255).any()  # frame 0 braked: its dot


def test_write_mp4_roundtrip(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    frames = rng.random((24, 180, 320)).astype(np.float32)
    path = write_mp4(frames, tmp_path / "clip.mp4", fps=20.0)
    assert path.exists() and path.stat().st_size > 1000
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    assert (n, w, h) == (24, 320, 180)


def test_write_mp4_uint8_rgb(tmp_path):
    frames = np.zeros((5, 64, 64, 3), np.uint8)
    frames[:, 10:20, 10:20] = 255
    path = write_mp4(frames, tmp_path / "rgb.mp4")
    assert path.exists() and path.stat().st_size > 100
