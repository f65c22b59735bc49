"""Port parity for the protocol (cli/full_benchmark.py, the port of
examples/full_benchmark.py) and the Trainer's shared ``device_data``.

* The method-spec grammar ``Method[:Dropout][@lambda][%ratio][!notemporal]``
  and its tag, on a table whose expected values follow
  examples/full_benchmark.py:325-353 (stated below), and the BC config each
  spec trains.
* Collection: the protocol's store for 2 routes x 2 seeds (a 6 m route
  whose worlds finish early, and route 3100) equals per-pair runs of
  cli.collect.collect seeded seed * 1000 + route (tests/test_torch_collect.py
  holds collect to JAX), episode by episode, route-major, each cut at its
  world's own state.t, bitwise on the CPU; and, drawing its own numbers
  (utils/prng.py), JAX's per-pair collection from PRNGKey(seed * 1000 +
  route) (examples/full_benchmark.py:113-126, 145) at
  tests/test_torch_collect.py's bars.
* The host confound against JAX's ops/raster.confounded_overlay on the same
  uint8 frames and actions: 255 on its dot mask where brake > 0.8, 242 on
  its bar mask, every other pixel unchanged.
* The whole ``main(..., device="cpu")`` at the smallest depth that runs
  every stage but the gaze predictor and the VQ-VAE: collection, the npz
  cache, human gaze, DeviceData, training, eval on the seen and unseen
  splits, report.json (its keys read from examples/full_benchmark.py's own
  dict literals), a second call that trains nothing, and a confounded,
  misperceived-gaze call from the cache.
"""

import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabril_carla_tpu.data.dataset import EpisodeStore as JaxEpisodeStore
from gabril_carla_tpu.ops.raster import confounded_overlay as jax_overlay
from gabril_carla_tpu_torch.cli import collect as port_collect
from gabril_carla_tpu_torch.cli import full_benchmark as fb
from gabril_carla_tpu_torch.data.dataset import BCDataset, EpisodeStore, synthetic_episodes
from gabril_carla_tpu_torch.data.tasks import seen_routes, unseen_routes
from gabril_carla_tpu_torch.env.criteria import compute_score
from gabril_carla_tpu_torch.env.world import (build_world_spec, load_benchmark_specs, spec_rows,
                                              stack_specs, to_torch)
from gabril_carla_tpu_torch.eval.rollout import needs_heat
from gabril_carla_tpu_torch.train.device_data import DeviceData
from gabril_carla_tpu_torch.train.loop import Trainer
from gabril_carla_tpu_torch.utils.config import default_bc_config
from test_torch_common import cpu_threads

REPO = Path(__file__).resolve().parents[1]
JAX_PROTOCOL = REPO / "examples" / "full_benchmark.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


# --- the method-spec grammar -------------------------------------------------

# spec -> (method, dropout, lambda, ratio, temporal, tag), as
# full_benchmark.py:327-339 parses it (strip "!notemporal", split "%", then
# "@", then ":") and :353 tags it (":" -> "-", "@" -> "-l", "%" -> "-r",
# "!" -> "-")
GRAMMAR = {
    "None": ("None", "None", None, None, True, "None"),
    "Reg@0.3": ("Reg", "None", 0.3, None, True, "Reg-l0.3"),
    "None:GMD": ("None", "GMD", None, None, True, "None-GMD"),
    "Reg:GMD@1.0": ("Reg", "GMD", 1.0, None, True, "Reg-GMD-l1.0"),
    "Reg@0.3%0.5": ("Reg", "None", 0.3, 0.5, True, "Reg-l0.3-r0.5"),
    "Reg@0.3!notemporal": ("Reg", "None", 0.3, None, False, "Reg-l0.3-notemporal"),
    "None:Oreo": ("None", "Oreo", None, None, True, "None-Oreo"),
    "Mask": ("Mask", "None", None, None, True, "Mask"),
}


class Args:
    batch_size, epochs, clip_norm = 32, 3, None


@pytest.mark.parametrize("spec", list(GRAMMAR))
def test_method_spec_grammar(spec):
    method, dropout, lam, ratio, temporal, tag = GRAMMAR[spec]
    ms = fb.parse_method_spec(spec)
    assert (ms.spec, ms.method, ms.dropout, ms.lam, ms.ratio, ms.temporal, ms.tag) == (
        spec, method, dropout, lam, ratio, temporal, tag)
    # the config of :341-361: unset lambda and ratio keep the defaults (10.0,
    # 1.0); only Oreo takes the VQ-VAE path
    cfg = fb.method_config(ms, Args, 7, "/vq/ep0", Path("/out"))
    assert cfg.gaze["method"] == method and cfg.dropout["method"] == dropout
    assert cfg.gaze["lambda_weight"] == (10.0 if lam is None else lam)
    assert cfg.gaze["ratio"] == (1.0 if ratio is None else ratio)
    assert cfg.gaze["temporal_flag"] is temporal
    assert cfg.dropout["vqvae_path"] == ("/vq/ep0" if dropout == "Oreo" else "")
    assert (cfg.data["batch_size"], cfg.data["task"]) == (32, "Mixed_")
    tr = cfg.training
    assert (tr["epochs"], tr["save_interval"], tr["seed"]) == (3, 3, 7)
    assert cfg.logging["log_dir"] == "/out/runs" and cfg.optimizer.get("clip_norm") is None
    # the frozen gaze predictor is trained for exactly these (:281-284)
    heat = method in ("Mask", "ViSaRL", "AGIL") or dropout in ("GMD", "IGMD")
    assert needs_heat(cfg) == heat


# --- collection ---------------------------------------------------------------

SHORT_ID, REAL_ID, SEEDS, STEPS = 7, 3100, (200, 201), 34


@functools.lru_cache(maxsize=None)
def collection_specs():
    """A 6 m route and route 3100, stacked."""
    wps = np.stack([np.arange(0.0, 6.0, 2.0), np.zeros(3)], 1).astype(np.float32)
    short = build_world_spec({"id": SHORT_ID, "town": "T", "waypoints": wps, "scenarios": [],
                              "weather": [0, 0, 0, 90], "weather_keys": []}, n_scen=1)
    return stack_specs([short, spec_rows(load_benchmark_specs([REAL_ID]), 0)])


@functools.lru_cache(maxsize=None)
def collection():
    """The protocol's collection and the per-pair collect runs it must equal."""
    specs = collection_specs()
    idx_of = {SHORT_ID: 0, REAL_ID: 1}
    store, records = fb.collect_expert(specs, idx_of, [SHORT_ID, REAL_ID], SEEDS, STEPS, True,
                                       "cpu")
    singles = []
    for r in (SHORT_ID, REAL_ID):
        for s in SEEDS:
            spec = to_torch(spec_rows(specs, np.asarray([idx_of[r]])), "cpu")
            draws = port_collect.seed_draws([s * 1000 + r], STEPS, "cpu")
            st, frames, actions, gazes = port_collect.collect(spec, STEPS, draws,
                                                              curvature_gaze=True)
            n = int(st.t[0])
            singles.append((r, s, n, frames[:n, 0].numpy(), actions[:n, 0].numpy(),
                            gazes[:n, 0].numpy(), compute_score(spec, st)))
    return store, records, singles


def test_collection_equals_per_pair_collect():
    store, records, singles = collection()
    assert store.n_demos == len(singles) == 4
    lengths = [n for _, _, n, *_ in singles]
    # the 6 m route's worlds finish early and are cut there; the real
    # route's run every tick
    assert all(n < STEPS for n in lengths[:2]) and lengths[2:] == [STEPS, STEPS]
    for d, (r, s, n, frames, actions, gazes, score) in enumerate(singles):
        assert store.images[d].shape == (n, 180, 320, 1) and store.images[d].dtype == np.uint8
        np.testing.assert_array_equal(store.images[d][..., 0], frames)
        np.testing.assert_array_equal(store.actions[d], actions)
        np.testing.assert_array_equal(store.gazes[d], gazes)
        rec = records[d]
        assert (rec["route_id"], rec["seed"]) == (f"RouteScenario_{r}", s)
        assert rec["meta"]["duration_game"] == round(n * 0.05, 3)
        assert rec["scores"]["score_composed"] == round(float(score["score_composed"][0]), 3)
    # the seeds' draws differ, and a pair's seed is seed * 1000 + route
    a, b = (port_collect.seed_draws([s * 1000 + REAL_ID], 4, "cpu") for s in SEEDS)
    assert not torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def jax_collection():
    """JAX's protocol collection of each pair alone: the jitted scan of
    examples/full_benchmark.py:113-126 (curvature gaze) from
    PRNGKey(seed * 1000 + route), on the same worlds."""
    import dataclasses

    import gabril_carla_tpu.env.world as JW
    from gabril_carla_tpu.env.criteria import compute_score as j_score
    from gabril_carla_tpu.env.env import DrivingEnv as JEnv
    from gabril_carla_tpu.env.expert import expert_action as j_expert
    from gabril_carla_tpu.eval.stats import route_record as j_record
    from gabril_carla_tpu.ops.raster import analytic_gaze as j_gaze
    from gabril_carla_tpu.ops.raster import render_frame as j_render

    env = JEnv()

    @jax.jit
    def collect(spec, key):
        def tick(state, _):
            frame = j_render(spec, state)
            gaze = j_gaze(spec, state, curvature_anticipation=True)
            action = j_expert(spec, state)
            return env.step(spec, state, action), (frame, action, gaze)

        state, outs = jax.lax.scan(tick, env.reset(spec, key), None, length=STEPS)
        return state, (outs[0] * 255.0).astype(jnp.uint8), outs[1], outs[2]

    specs = collection_specs()
    out = []
    for i, r in enumerate((SHORT_ID, REAL_ID)):
        spec = JW.WorldSpec(**{f.name: jnp.asarray(getattr(specs, f.name)[i])
                               for f in dataclasses.fields(JW.WorldSpec)})
        for s in SEEDS:
            st, frames, actions, gazes = collect(spec, jax.random.PRNGKey(s * 1000 + r))
            n = int(st.t)
            rec = j_record(r, s, j_score(spec, st), duration_game=n * 0.05,
                           route_length=float(spec.route_len))
            out.append((n, np.asarray(frames[:n]), np.asarray(actions[:n]), np.asarray(gazes[:n]),
                        rec))
    return out


def test_collection_own_draws_match_jax():
    """The protocol's batched collection, drawing its own numbers, against
    JAX's per-pair collection."""
    from test_torch_expert import JIT_TOL

    store, records, _ = collection()
    for d, (n, frames, actions, gazes, rec) in enumerate(jax_collection()):
        assert store.images[d].shape[0] == n > 0
        diff = np.abs(store.images[d][..., 0].astype(np.int16) - frames.astype(np.int16))
        assert (diff > 0).mean() < 0.01 and np.median(diff) == 0
        np.testing.assert_array_equal(store.actions[d][:, 2:], actions[:, 2:])
        np.testing.assert_allclose(store.actions[d][:, :2], actions[:, :2], rtol=0, atol=JIT_TOL)
        np.testing.assert_allclose(store.gazes[d], gazes, rtol=0, atol=1e-4)
        assert records[d] == rec


# --- the host confound ----------------------------------------------------------


def test_confound_matches_jax_overlay():
    rng = np.random.default_rng(3)
    t, h, w = 12, 180, 320
    images = rng.integers(0, 256, (t, h, w, 1), dtype=np.uint8)
    actions = rng.standard_normal((t, 7)).astype(np.float32)
    actions[:, 1] = np.linspace(-1.5, 1.5, t)  # steer past both clamps
    actions[::3, 2] = 0.9  # brake on every third frame, off (or below 0.8) elsewhere
    actions[1::3, 2] = 0.8
    store = EpisodeStore()
    store.add(images[:5], np.zeros((5, 10), np.float32), actions[:5])
    store.add(images[5:], np.zeros((t - 5, 10), np.float32), actions[5:])
    fb.confound_store(store)
    # JAX's overlay of a blank frame marks its masks: 1.0 the dot, 0.95 the bar
    marks = np.asarray(jax.vmap(jax_overlay)(jnp.zeros((t, h, w)), jnp.asarray(actions)))
    dot, bar = marks == np.float32(1.0), marks == np.float32(0.95)
    assert dot[::3].any() and not dot[1::3].any() and bar.any()
    want = np.where(dot, 255, np.where(bar, 242, images[..., 0])).astype(np.uint8)
    np.testing.assert_array_equal(store.flat_images[..., 0], want)
    assert all(np.shares_memory(e, store.flat_images) for e in store.images)


# --- Trainer(device_data=) ------------------------------------------------------


def tiny_cfg(root):
    cfg = default_bc_config()
    cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1,
                        num_residual_hiddens=4, z_dim=8)
    cfg["data"].update(img_height=24, img_width=48, batch_size=4)
    cfg["training"].update(epochs=2, compute_dtype="float32", save_interval=99)
    cfg["logging"]["log_dir"] = str(root)
    return cfg


def test_trainer_uses_given_device_data(tmp_path):
    """A given DeviceData is used as it is; training on it equals training
    on the Trainer's own copy, bit for bit."""
    ds = BCDataset(synthetic_episodes(n_demos=2, steps=8, img_hw=(24, 48)), 2)
    cfg = tiny_cfg(tmp_path)
    dd = DeviceData(ds.store, 2, grayscale_store=True, device="cpu")
    shared = Trainer(cfg, ds, device="cpu", device_data=dd)
    own = Trainer(tiny_cfg(tmp_path), ds, device="cpu")
    assert shared.device_data is dd and own.device_data is not dd
    assert shared.train() == own.train()
    for k, v in own.state.params.items():
        assert torch.equal(shared.state.params[k], v), k


# --- the whole protocol on the CPU ----------------------------------------------


def jax_literal_keys():
    """The keys of report.json's dicts and of the npz cache, read from
    examples/full_benchmark.py's source."""
    tree = ast.parse(JAX_PROTOCOL.read_text())
    dicts, savez = {}, None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            dicts[ast.unparse(node.targets[0])] = {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and ast.unparse(node.func) == "np.savez":
            savez = {k.arg for k in node.keywords}
    return dicts["report"], dicts["report['methods'][method_spec]"], savez


TINY = ["--train_seeds", "200", "--eval_seeds", "400", "--collect_steps", "3",
        "--eval_steps", "2", "--epochs", "1", "--batch_size", "16", "--methods", "None"]


@functools.lru_cache(maxsize=None)
def protocol(tmp):
    root = Path(tmp)
    cache = root / "cache.npz"
    args = TINY + ["--store_cache", str(cache), "--out", str(root / "run")]
    assert fb.main(args, device="cpu") == 0
    first = (root / "run" / "report.json").read_text()
    with pytest.MonkeyPatch.context() as mp:
        def no_training(*a, **kw):
            raise AssertionError("a finished cell was trained again")

        mp.setattr(fb, "Trainer", no_training)
        assert fb.main(args, device="cpu") == 0
    again = (root / "run" / "report.json").read_text()
    assert fb.main(TINY + ["--store_cache", str(cache), "--out", str(root / "confounded"),
                           "--confounded", "--misperceive_gaze"], device="cpu") == 0
    return root, first, again


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return protocol(str(tmp_path_factory.mktemp("protocol")))


def test_report_and_stats(run):
    root, first, again = run
    report_keys, cell_keys, _ = jax_literal_keys()
    for out, confounded in ((root / "run", False), (root / "confounded", True)):
        report = json.loads((out / "report.json").read_text())
        assert set(report) == report_keys and set(report["methods"]) == {"None"}
        assert set(report["methods"]["None"]) == cell_keys
        assert report["confounded"] is confounded and report["train_seed"] == 42
        assert report["n_frames"] == 10 * 3
        cell = report["methods"]["None"]
        assert np.isfinite([cell["seen"], cell["unseen"], cell["final_loss"]["loss"]]).all()
        for split, routes in (("seen", seen_routes()), ("unseen", unseen_routes())):
            files = sorted(out.glob(f"eval_None_{split}/route_*/seed_400/stats.json"))
            assert sorted(f.parent.parent.name for f in files) == sorted(
                f"route_{r}" for r in routes)
            assert set(cell[f"per_route_{split}"]) == {f"RouteScenario_{r}" for r in routes}
    assert again == first  # the second call trained and evaluated nothing


def test_cache_round_trip(run):
    """The cache holds JAX's keys and loads the same in both packages'
    stores (JAX's loader, full_benchmark.py:132-141, replayed with its
    EpisodeStore); its gaze is the analytic gaze as collected."""
    root, first, _ = run
    _, _, savez_keys = jax_literal_keys()
    z = np.load(root / "cache.npz", allow_pickle=True)
    assert set(z.files) == savez_keys
    store, records = fb.load_cache(root / "cache.npz")
    jstore = JaxEpisodeStore()
    bounds = np.cumsum(z["lengths"])[:-1]
    for img, gz, ac in zip(np.split(z["images"], bounds), np.split(z["gazes"], bounds),
                           np.split(z["actions"], bounds)):
        jstore.add(img, gz, ac)
    store.finalize(), jstore.finalize()
    for k in ("flat_images", "flat_gazes", "flat_actions", "lengths"):
        np.testing.assert_array_equal(getattr(store, k), getattr(jstore, k), err_msg=k)
    assert store.n_demos == 10 and store.flat_images.shape == (30, 180, 320, 1)
    assert [r["route_id"] for r in records] == [f"RouteScenario_{r}" for r in seen_routes()]
    expert = json.loads(first)["expert_seen_mean"]
    assert expert == pytest.approx(np.mean([r["scores"]["score_composed"] for r in records]))
    # collected gaze: the road point is valid on most frames (no dropout yet)
    assert (store.flat_gazes[:, 0] >= 0).mean() > 0.5
