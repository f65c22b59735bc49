"""Port parity for env/xosc.py and the CLIs' ``--xosc``.

``load_xosc`` against the JAX package's on the vendored ScenarioRunner
examples and on tests/test_xosc.py's synthetic storyboards (its tests run
as they are, with JAX's load_xosc wrapped to record each file they parse):
the route dicts equal, the waypoints bitwise, the same ValueError for the
gated constructs (LanePosition, RoadPosition), and the compiled WorldSpec
bitwise. Then ``eval_routes --xosc --video`` and ``collect --xosc`` on the
CPU against JAX's CLIs, with JAX's draws replayed: eval_routes on a
checkpoint saved by each package with the same weights (the actor's last
layer zeroed, its throttle bias raised, so both packages' bf16 policies
give the same constant action and the worlds' own dynamics are what is
compared), stats.json equal but for the wall time, also when the port
draws its own numbers (utils/prng.py); collect at
tests/test_torch_collect.py's bars.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gabril_carla_tpu.env.world as JW
import gabril_carla_tpu.train.bc as JB
import test_xosc as jax_xosc_tests
from chip_smoke import without_wall
from gabril_carla_tpu.cli import collect as jax_collect
from gabril_carla_tpu.cli import eval_routes as jax_eval_routes
from gabril_carla_tpu.env.xosc import load_xosc as jax_load_xosc
from gabril_carla_tpu.train.checkpoint import save_manifest as jax_save_manifest
from gabril_carla_tpu.train.checkpoint import save_params as jax_save_params
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.cli import collect, eval_routes
from gabril_carla_tpu_torch.data.vendored import XOSC_EXAMPLES, xosc_example
from gabril_carla_tpu_torch.env import world as PW
from gabril_carla_tpu_torch.env.xosc import load_xosc
from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
from gabril_carla_tpu_torch.train.checkpoint import save_manifest, save_params
from test_torch_collect import jax_draws
from test_torch_common import cpu_threads
from test_torch_expert import JIT_TOL
from test_torch_rollout import small_cfg

EVAL_XOSC, COLLECT_XOSC = "PedestrianCrossingFront", "CyclistCrossing"
EVAL_STEPS, COLLECT_STEPS, EVAL_SEEDS, COLLECT_SEEDS = 32, 24, (400, 7), (200,)

# tests/test_xosc.py's storyboard tests: name -> (test function, file it writes)
SYNTHETIC = {
    "synthetic": jax_xosc_tests.test_synthetic_parse,
    "lane_position_gated": jax_xosc_tests.test_lane_position_gated,
    "multi_adversary": jax_xosc_tests.test_multi_adversary_storyboard,
    "trigger_entity_ref": jax_xosc_tests.test_trigger_condition_entityref_does_not_claim_group,
    "init_only_parked_prop": jax_xosc_tests.test_init_only_vehicle_is_parked_prop,
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


@functools.lru_cache(maxsize=None)
def storyboards(tmp) -> dict:
    """name -> path of every storyboard: the vendored examples, and the
    files tests/test_xosc.py's tests write (each run in a directory of its
    own, its assertions kept)."""
    paths = {Path(n).stem: xosc_example(n) for n in XOSC_EXAMPLES}
    for name, test in SYNTHETIC.items():
        d = Path(tmp) / name
        d.mkdir()
        seen = []

        def spy(path, *a, **kw):
            seen.append(Path(path))
            return jax_load_xosc(path, *a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_xosc_tests, "load_xosc", spy)
            if name == "synthetic":
                (d / "SynthCrossing.xosc").write_text(jax_xosc_tests.SYNTH)
                test(d / "SynthCrossing.xosc")
            else:
                test(d)
        paths[name] = seen[0]
    return paths


@pytest.fixture(scope="module")
def boards(tmp_path_factory):
    return storyboards(str(tmp_path_factory.mktemp("xosc")))


NAMES = [Path(n).stem for n in XOSC_EXAMPLES] + list(SYNTHETIC)


def parse_both(path):
    """(JAX's route dict, the port's), or the ValueError both raise."""
    try:
        want = jax_load_xosc(path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            load_xosc(path)
        assert str(got.value) == str(e)
        return None
    return want, load_xosc(path)


@pytest.mark.parametrize("name", NAMES)
def test_load_xosc_matches_jax(boards, name):
    both = parse_both(boards[name])
    if both is None:
        assert name in ("FollowLeadingVehicle", "lane_position_gated")
        return
    want, got = both
    assert got.keys() == want.keys()
    assert got["waypoints"].dtype == want["waypoints"].dtype
    np.testing.assert_array_equal(got["waypoints"], want["waypoints"])
    for k in want.keys() - {"waypoints"}:
        assert got[k] == want[k], k


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n not in ("FollowLeadingVehicle", "lane_position_gated")])
def test_world_spec_bitwise(boards, name):
    want = JW.build_world_spec(jax_load_xosc(boards[name]))
    got = PW.build_world_spec(load_xosc(boards[name]))
    for f in dataclasses.fields(JW.WorldSpec):
        a, b = np.asarray(getattr(want, f.name)), np.asarray(getattr(got, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def constant_policy_params():
    """Small-width JAX BC params whose actor ignores its input: the last
    layer's kernel zeroed, its bias throttle 0.6 and nothing else."""
    cfg = small_cfg()
    params = JB.init_bc_params(JB.build_bc_models(cfg), cfg, jax.random.PRNGKey(0))
    last = params["actor"]["Dense_1"]
    params["actor"]["Dense_1"] = {"kernel": jnp.zeros_like(last["kernel"]),
                                  "bias": jnp.zeros_like(last["bias"]).at[0].set(0.6)}
    return cfg, params


def xosc_keys(xosc_id):
    def keys(pairs):
        assert all(r == xosc_id for r, _ in pairs)
        return np.asarray(jnp.stack([jax.random.PRNGKey(s * 100003 + r) for r, s in pairs]))
    return keys


@functools.lru_cache(maxsize=None)
def eval_runs(tmp):
    root = Path(tmp)
    cfg, params = constant_policy_params()
    jax_save_params(root / "jax_ckpt", 1, params)
    jax_save_manifest(root / "jax_ckpt", cfg, 1)
    pcfg = small_cfg(port=True)
    save_params(root / "port_ckpt", 1, convert.params_from_flax(jax.tree.map(np.asarray, params),
                                                                pcfg))
    save_manifest(root / "port_ckpt", pcfg, 1)
    path = str(xosc_example(f"{EVAL_XOSC}.xosc"))
    args = ["--xosc", path, "--steps", str(EVAL_STEPS), "--seeds", *map(str, EVAL_SEEDS)]
    assert jax_eval_routes.main(["--checkpoint", str(root / "jax_ckpt"), "--out",
                                 str(root / "jax")] + args) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eval_routes, "pair_keys", xosc_keys(load_xosc(path)["id"]))
        before = render_kernel.launches
        assert eval_routes.main(["--checkpoint", str(root / "port_ckpt"), "--out",
                                 str(root / "port"), "--video"] + args, device="cpu") == 0
        assert render_kernel.launches == before  # CPU tensors take the plain render
    return root, load_xosc(path)["id"]


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    return eval_runs(str(tmp_path_factory.mktemp("xosc_eval")))


@pytest.mark.parametrize("seed", EVAL_SEEDS)
def test_eval_routes_xosc_matches_jax(evals, seed):
    root, rid = evals
    one = f"route_{rid}/seed_{seed}/stats.json"
    want = json.loads((root / "jax" / one).read_text())
    got = json.loads((root / "port" / one).read_text())
    assert without_wall(got) == without_wall(want)
    assert got["route_id"] == f"RouteScenario_{rid}"
    # the constant throttle drove the ego along the storyboard's route
    assert got["scores"]["score_route"] > 0


@pytest.mark.parametrize("seed", EVAL_SEEDS)
def test_eval_routes_own_draws_match_jax(evals, tmp_path_factory, seed):
    """eval_routes drawing its own numbers (utils/prng.py, nothing
    replayed) writes JAX's stats.json."""
    root, rid = evals
    own = own_eval(str(root), str(tmp_path_factory.getbasetemp()))
    one = f"route_{rid}/seed_{seed}/stats.json"
    want = json.loads((root / "jax" / one).read_text())
    assert without_wall(json.loads((own / one).read_text())) == without_wall(want)


@functools.lru_cache(maxsize=None)
def own_eval(root, base):
    out = Path(base) / "xosc_own_eval"
    args = ["--xosc", str(xosc_example(f"{EVAL_XOSC}.xosc")), "--steps", str(EVAL_STEPS),
            "--seeds", *map(str, EVAL_SEEDS)]
    assert eval_routes.main(["--checkpoint", str(Path(root) / "port_ckpt"), "--out", str(out)]
                            + args, device="cpu") == 0
    return out


def test_eval_routes_video(evals):
    """--video: one rollout.mp4 per pair beside its stats.json, a frame per
    tick the world ran."""
    import cv2

    root, rid = evals
    for seed in EVAL_SEEDS:
        ep = root / "port" / f"route_{rid}" / f"seed_{seed}"
        ticks = round(json.loads((ep / "stats.json").read_text())["meta"]["duration_game"] / 0.05)
        cap = cv2.VideoCapture(str(ep / "rollout.mp4"))
        assert cap.isOpened()
        got = tuple(int(cap.get(k)) for k in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FRAME_WIDTH,
                                              cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        assert got == (max(ticks, 1), 320, 180)


@functools.lru_cache(maxsize=None)
def collect_runs(tmp):
    root = Path(tmp)
    args = ["--xosc", str(xosc_example(f"{COLLECT_XOSC}.xosc")), "--steps", str(COLLECT_STEPS),
            "--seeds", *map(str, COLLECT_SEEDS)]
    assert jax_collect.main(args + ["--out", str(root / "jax")]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(collect, "seed_draws", jax_draws)
        assert collect.main(args + ["--out", str(root / "port")], device="cpu") == 0
    return root


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    return collect_runs(str(tmp_path_factory.mktemp("xosc_collect")))


@pytest.mark.parametrize("seed", COLLECT_SEEDS)
def test_collect_xosc_matches_jax(collected, seed):
    def episode(root):
        ep = root / f"route_{COLLECT_XOSC}" / f"seed_{seed}"
        return ({k: np.load(ep / f"{k}.npz")[k] for k in ("observations", "actions", "gaze")},
                json.loads((ep / "stats.json").read_text()))

    (want, want_stats), (got, got_stats) = episode(collected / "jax"), episode(collected / "port")
    n = len(want["actions"])
    assert n > 0 and all(len(v) == n for v in got.values())
    d = np.abs(got["observations"].astype(np.int16) - want["observations"].astype(np.int16))
    assert (d > 0).mean() < 0.01 and np.median(d) == 0
    np.testing.assert_array_equal(got["actions"][:, 2:], want["actions"][:, 2:])
    np.testing.assert_allclose(got["actions"][:, :2], want["actions"][:, :2], rtol=0, atol=JIT_TOL)
    np.testing.assert_allclose(got["gaze"], want["gaze"], rtol=0, atol=1e-4)
    assert got_stats == want_stats and got_stats["route_id"] == f"RouteScenario_{COLLECT_XOSC}"
