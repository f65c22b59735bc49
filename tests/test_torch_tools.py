"""Port parity: the tools (cli/visualize.py, cli/figures.py,
utils/profiling.py) and the heads mlp_head and Projector (models/heads.py,
convert.head_params_from_flax).

triptych is bitwise the JAX package's. visualize.panels' heat is within
1e-5 of JAX's GazeHeatmapper and its panels within one uint8 level of
JAX's triptychs; visualize.main on an HDF5 written by the converter writes
a GIF of the frames JAX's main writes (decoded, within one level on all
but 1% of values: GIF palettes quantize). figures.main writes the PNG names
JAX's writes for tests/test_config.py's reports, and _collect is equal.
profile_trace writes a Chrome trace of the block on the CPU (and nothing
when disabled; its spans are tests/test_torch_tracing.py's). mlp_head and
Projector, carried from flax params, give flax's outputs within 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

import gabril_carla_tpu.cli.figures as JF
import gabril_carla_tpu.cli.visualize as JVZ
import gabril_carla_tpu.models.heads as JHD
import gabril_carla_tpu_torch.cli.figures as PF
import gabril_carla_tpu_torch.cli.visualize as PVZ
import gabril_carla_tpu_torch.models.heads as PHD
import gabril_carla_tpu_torch.utils.profiling as PPR
from gabril_carla_tpu.ops.heatmap import GazeHeatmapper as JHeatmapper
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.data.converter import convert_episodes
from test_torch_common import cpu_threads

HEAT_TOL, HEAD_TOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def episode_arrays(t=12, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (t, 180, 320, 3), dtype=np.uint8)
    gaze = rng.random((t, 10)).astype(np.float32)
    gaze[:, 4:] = -1.0  # two points a frame, three padded
    gaze[3, :2] = -1.0  # a frame whose first point is missing
    return images, gaze, rng.standard_normal((t, 7)).astype(np.float32)


def test_triptych_bitwise():
    images, _, _ = episode_arrays(t=4)
    heat = np.random.default_rng(1).random((4, 180, 320)).astype(np.float32) * 1.2 - 0.1
    for i in range(4):
        np.testing.assert_array_equal(PVZ.triptych(images[i], heat[i]), JVZ.triptych(images[i], heat[i]))


@pytest.mark.parametrize("sigma", [30.0, 8.0])
def test_panels_match_jax(sigma):
    images, gaze, _ = episode_arrays()
    heat, tri = PVZ.panels(images, gaze, sigma, device="cpu")
    want = np.asarray(JHeatmapper(img_height=180, img_width=320, gaze_sigma=sigma,
                                  maxpoints=5).heatmaps(jax.numpy.asarray(gaze[None]))[0])
    assert heat.shape == want.shape and heat.dtype == np.float32
    np.testing.assert_allclose(heat, want, rtol=0, atol=HEAT_TOL)
    jtri = np.stack([JVZ.triptych(images[i], want[i]) for i in range(len(images))])
    assert tri.shape == (len(images), 180, 960, 3) and tri.dtype == np.uint8
    assert np.abs(tri.astype(np.int16) - jtri).max() <= 1


def gif_frames(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])


def test_visualize_main_on_converted_hdf5(tmp_path):
    images, gaze, actions = episode_arrays(t=20)
    ep = tmp_path / "episodes" / "route_3100" / "seed_1"
    ep.mkdir(parents=True)
    np.savez_compressed(ep / "observations.npz", observations=images)
    np.savez_compressed(ep / "actions.npz", actions=actions)
    np.savez_compressed(ep / "gaze.npz", gaze=gaze)
    h5 = tmp_path / "data.hdf5"
    assert convert_episodes(tmp_path / "episodes", h5) == 1
    args = ["--hdf5", str(h5), "--frames", "6", "--stride", "3"]
    assert PVZ.main(args + ["--out", str(tmp_path / "port.gif")], device="cpu") == 0
    assert JVZ.main(args + ["--out", str(tmp_path / "jax.gif")]) == 0
    got, want = gif_frames(tmp_path / "port.gif"), gif_frames(tmp_path / "jax.gif")
    assert got.shape == want.shape == (6, 180, 960, 3)
    diff = np.abs(got.astype(np.int16) - want)
    assert (diff > 1).mean() < 0.01, (diff > 1).mean()


def figure_reports(tmp_path):
    """tests/test_config.py: test_figures_cli's reports."""
    reps = []
    for i, scale in enumerate((1.0, 1.05)):
        rep = {"methods": {
            "None": {"seen": 60 * scale, "unseen": 40},
            "Reg@0.3": {"seen": 80 * scale, "unseen": 50},
            "Reg@0.1": {"seen": 70, "unseen": 45},
            "Reg@1.0": {"seen": 55, "unseen": 30},
            "Reg@0.3%0.25": {"seen": 62, "unseen": 41},
            "Reg@0.3%0.75": {"seen": 71, "unseen": 44},
        }}
        p = tmp_path / f"rep{i}.json"
        p.write_text(json.dumps(rep))
        reps.append(str(p))
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"methods": {
        "None": {"seen": 33, "unseen": 20},
        "Reg@0.3": {"seen": 45, "unseen": 30},
    }}))
    ladder = {}
    for rung in ("sparse", "human"):
        lp = tmp_path / f"{rung}.json"
        lp.write_text(json.dumps({"methods": {
            "GRIL": {"seen": 59, "unseen": 33},
            "None:GMD": {"seen": 70, "unseen": 40},
            "Reg@0.3": {"seen": 72, "unseen": 31},
        }}))
        ladder[rung] = str(lp)
    dense = tmp_path / "dense_extra.json"
    dense.write_text(json.dumps({"methods": {
        "GRIL": {"seen": 61, "unseen": 35}, "None:GMD": {"seen": 60, "unseen": 41},
    }}))
    return reps + [str(dense)], str(conf), ladder


def test_figures_match_jax(tmp_path):
    reps, conf, ladder = figure_reports(tmp_path)
    assert PF._collect(reps) == JF._collect(reps)
    assert PF._collect([conf]) == JF._collect([conf])
    args = ["--reports", *reps, "--conf_reports", conf, "--ladder_sparse", ladder["sparse"],
            "--ladder_human", ladder["human"]]
    assert PF.main(args + ["--out", str(tmp_path / "port")]) == 0
    assert JF.main(args + ["--out", str(tmp_path / "jax")]) == 0
    names = sorted(f.name for f in (tmp_path / "port").glob("*.png"))
    assert names == sorted(f.name for f in (tmp_path / "jax").glob("*.png"))
    assert {"methods_bar.png", "lambda_curve.png", "ratio_curve.png", "confounded_bar.png",
            "ladder_bar.png"} <= set(names)
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    none = ["--reports", str(empty), "--out", str(tmp_path / "none")]
    assert PF.main(none) == JF.main(none) == 1  # no method results


def test_profile_trace_writes_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with PPR.profile_trace(str(tmp_path / "on")) as prof:
        (x @ x).sum()
    assert prof is not None
    files = list((tmp_path / "on").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names
    with PPR.profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        (x @ x).sum()
    assert prof is None and not (tmp_path / "off").exists()


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("kind", ["mlp_head", "projector"])
def test_heads_match_flax(kind, depth):
    x = np.random.default_rng(depth).standard_normal((5, 24)).astype(np.float32)
    if kind == "mlp_head":
        jmod = JHD.mlp_head(32 if depth else None, 6, depth)
        pmod = PHD.mlp_head(24, 32 if depth else None, 6, depth)
    else:
        jmod = JHD.Projector(6, hidden_dim=32, hidden_depth=depth)
        pmod = PHD.Projector(24, 6, hidden_dim=32, hidden_depth=depth)
    params = jmod.init(jax.random.PRNGKey(depth), x)["params"]
    want = np.asarray(jmod.apply({"params": params}, x))
    pmod.load_state_dict(convert.head_params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_TOL)
