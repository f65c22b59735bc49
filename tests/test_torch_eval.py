"""Port parity: the eval harness (eval/agent.py, eval/stats.py,
cli/eval_routes.py, cli/calc_scores.py) and the training CLIs.

manifest_to_config equals the JAX package's; route_record's JSON is
byte-equal to JAX's for the same score dicts (completed, with infractions,
deviated, blocked) and aggregate_scores equal. End to end on the CPU at
180x320 with tiny widths: the gaze predictor and a Mask policy trained by
the Trainer, a BCAgent rebuilt from the checkpoint with its frozen
predictor (only CPU tensors when built with device="cpu"), eval_routes on 2
routes x 2 seeds x 12 steps, its resume, a subset run whose stats.json
equals the full run's (all but the wall-clock duration_system), and
calc_scores reading the tree back.
"""

import functools
import json
import sys

import numpy as np
import pytest
import torch

from chip_smoke import without_wall
from gabril_carla_tpu.eval.agent import manifest_to_config as j_manifest_to_config
from gabril_carla_tpu.eval.stats import aggregate_scores as j_aggregate_scores
from gabril_carla_tpu.eval.stats import route_record as j_route_record
from gabril_carla_tpu_torch.cli import calc_scores, eval_routes, train_bc, train_gaze_predictor
from gabril_carla_tpu_torch.data.tasks import seen_routes
from gabril_carla_tpu_torch.eval.agent import BCAgent, manifest_to_config
from gabril_carla_tpu_torch.eval.stats import aggregate_scores, route_record, write_stats_json

TINY = ["model.embedding_dim=4", "model.num_hiddens=8", "model.num_residual_layers=1",
        "model.num_residual_hiddens=4", "model.z_dim=8", "data.batch_size=64",
        "training.epochs=1", "training.compute_dtype=float32", "scheduler.type=none"]
ROUTES = seen_routes()[3:5]


@pytest.mark.parametrize("manifest", [
    {},
    {"gaze_method": "Mask", "dp_method": "GMD", "stack": 3, "embedding_dim": 8, "z_dim": 16},
    {"gaze_method": "AGIL", "arch": "unet", "grayscale": False, "num_embeddings": 64,
     "action_dim": 5, "num_hiddens": 32, "num_residual_layers": 1, "num_residual_hiddens": 8},
])
def test_manifest_to_config_matches_jax(manifest):
    assert manifest_to_config(manifest).to_dict() == j_manifest_to_config(manifest).to_dict()


def score(**kw):
    base = dict(score_route=100.0, score_penalty=1.0, score_composed=100.0, collisions_vehicle=0,
                collisions_pedestrian=0, collisions_static=0, red_light=0, stop_infraction=0,
                outside_route_lanes_pct=0.0, min_speed_penalty=1.0, scenario_timeout=0,
                yield_emergency=False, blocked=False, deviated=False)
    base.update(kw)
    return {k: np.float32(v) if isinstance(v, float) else np.int32(v) if isinstance(v, int)
            else np.bool_(v) for k, v in base.items()}


SCORES = {
    "perfect": score(),
    "completed_with_infractions": score(
        score_penalty=0.4132, score_composed=41.3217, collisions_vehicle=1, red_light=2,
        collisions_static=1, outside_route_lanes_pct=3.51, min_speed_penalty=0.8123,
        scenario_timeout=1, yield_emergency=True),
    "deviated": score(score_route=40.123456, score_composed=38.0001, score_penalty=0.947,
                      deviated=True, collisions_pedestrian=1),
    "blocked": score(score_route=12.3456, score_composed=12.3456, blocked=True,
                     outside_route_lanes_pct=0.4),
}


@pytest.mark.parametrize("name", list(SCORES))
def test_route_record_json_matches_jax(tmp_path, name):
    args = (3100, 400, SCORES[name])
    kw = dict(duration_game=61.35, duration_system=0.123456, route_length=812.25,
              duration_system_mode="batch_amortized")
    got, want = route_record(*args, **kw), j_route_record(*args, **kw)
    assert json.dumps(got, indent=2) == json.dumps(want, indent=2)
    path = write_stats_json(tmp_path, got)
    assert path == tmp_path / "route_3100" / "seed_400" / "stats.json"
    assert path.read_text() == json.dumps(want, indent=2)


def test_aggregate_scores_match_jax():
    recs = [route_record(r, s, SCORES[n], duration_game=1.0)
            for r, s, n in [(1, 1, "perfect"), (1, 2, "deviated"), (2, 1, "blocked"),
                            (3, 5, "completed_with_infractions")]]
    assert aggregate_scores(recs) == j_aggregate_scores(recs)
    assert aggregate_scores([]) == j_aggregate_scores([])


@functools.lru_cache(maxsize=None)
def trained(root):
    """A gaze predictor and a Mask policy trained through the CLIs, on the
    CPU, into ``root``: (gaze checkpoint dir, BC checkpoint dir)."""
    from pathlib import Path

    root = Path(root)
    log = [f"logging.log_dir={root}"]
    assert train_gaze_predictor.main(TINY + log + ["data.task=Gaze"], device="cpu") == 0
    gaze_ckpt = next(root.glob("Gaze/*/checkpoints"))
    assert train_bc.main(TINY + log + ["data.task=Bc", "gaze.method=Mask",
                                       f"gaze.predictor_path={gaze_ckpt}"], device="cpu") == 0
    return gaze_ckpt, next(root.glob("Bc/*/checkpoints"))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return trained(str(tmp_path_factory.mktemp("runs")))


def test_cli_refuses_waiting_parts(tmp_path, monkeypatch):
    """eval_routes refuses, before it loads a checkpoint, what it cannot
    run: a storyboard that needs the OpenDRIVE map (RoadPosition), and
    --video where cv2 does not import (the error names cv2)."""
    from gabril_carla_tpu_torch.data.vendored import xosc_example

    with pytest.raises(ValueError, match="RoadPosition"):
        eval_routes.main(["--checkpoint", str(tmp_path), "--xosc",
                          str(xosc_example("FollowLeadingVehicle.xosc"))], device="cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)  # cv2 made unimportable
    with pytest.raises(ImportError, match="cv2"):
        eval_routes.main(["--checkpoint", str(tmp_path), "--video"], device="cpu")


def test_agent_rebuilds_policy_and_predictor(ckpts):
    gaze_ckpt, bc_ckpt = ckpts
    gm = json.loads((gaze_ckpt / "params.json").read_text())
    assert gm["model_type"] == "gaze_predictor" and gm["epochs"] == 1
    agent = BCAgent(bc_ckpt, device="cpu")
    assert agent.cfg["gaze"]["method"] == "Mask" and agent.gaze_predictor_apply is not None
    assert set(agent.params["gaze_predictor"]) == set(torch.load(gaze_ckpt / "ep1" / "params.pt"))
    leaves = [v for k, v in agent.params.items() if k != "gaze_predictor"]
    leaves += list(agent.params["gaze_predictor"].values())
    assert all(v.device.type == "cpu" for v in leaves)
    obs = torch.rand(2, 180, 320, 2)
    heat = agent.gaze_predictor_apply(agent.params["gaze_predictor"], obs)
    assert heat.shape == (2, 180, 320, 1)
    act = agent.policy_fn()(agent.params, obs, heat.clamp(0, 1).repeat(1, 1, 1, 2))
    assert act.shape == (2, 7) and bool(torch.isfinite(act).all())


def test_eval_routes_resume_subset_and_calc_scores(ckpts, tmp_path, monkeypatch, capsys):
    _, bc_ckpt = ckpts
    monkeypatch.setitem(eval_routes.TASK_TO_ROUTE, "Two_", {"test": [(r, 400) for r in ROUTES]})
    args = ["--checkpoint", str(bc_ckpt), "--task", "Two_", "--seeds", "1", "2", "--steps", "12"]
    full, sub = tmp_path / "full", tmp_path / "sub"
    assert eval_routes.main(args + ["--out", str(full)], device="cpu") == 0
    files = sorted(full.glob("route_*/seed_*/stats.json"))
    assert [f.parent.parent.name + "/" + f.parent.name for f in files] == [
        f"route_{r}/seed_{s}" for r in ROUTES for s in (1, 2)]
    agg = json.loads((full / "aggregate.json").read_text())
    assert agg["n"] == 4
    rec = json.loads(files[0].read_text())
    assert rec["meta"]["duration_game"] == 0.6 and "_checkpoint" in rec

    capsys.readouterr()
    assert eval_routes.main(args + ["--out", str(full)], device="cpu") == 0
    assert "Nothing to do" in capsys.readouterr().out

    r, s = ROUTES[1], 2
    assert eval_routes.main(["--checkpoint", str(bc_ckpt), "--route_id", str(r), "--seeds", str(s),
                             "--steps", "12", "--out", str(sub)], device="cpu") == 0
    one = f"route_{r}/seed_{s}/stats.json"
    assert without_wall(json.loads((sub / one).read_text())) == without_wall(
        json.loads((full / one).read_text()))

    capsys.readouterr()
    assert calc_scores.main(["--stats_dir", str(full)]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out) == agg
    assert "batch-amortized" in out.err
    assert calc_scores.main(["--stats_dir", str(tmp_path / "none")]) == 1
