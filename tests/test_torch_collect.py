"""Port parity for the collection CLI (cli/collect.py): the port's
``collect.main`` against the JAX package's on one real route, two seeds,
STEPS ticks, with JAX's draws replayed (the port's per-seed generators
patched out). Each episode's frames meet tests/test_raster.py's bar in
uint8 (under 1% of pixels differ at all, median difference 0), gaze agrees
within 1e-4, stats.json is equal (it carries no wall time: duration_system
stays -1 in both), brake is equal, and throttle and steer agree within
test_torch_expert.JIT_TOL: JAX's CLI runs the expert jitted, where XLA's
FMAs move the steer by up to 2.3e-4 of JAX's own op-by-op value
(test_torch_expert.py holds the expert to JAX op by op at 1e-5). Also the
``--replay`` round trip, ``--video`` and the ``--xosc`` refusal.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from gabril_carla_tpu.cli import collect as jax_collect
from gabril_carla_tpu_torch.cli import collect
from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
from test_torch_common import cpu_threads, rollout_draws
from test_torch_expert import JIT_TOL

ROUTE, SEEDS, STEPS = 3100, (200, 201), 60
ARGS = ["--route", str(ROUTE), "--steps", str(STEPS), "--seeds", *map(str, SEEDS)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def episode(root, seed):
    ep = root / f"route_{ROUTE}" / f"seed_{seed}"
    return ({k: np.load(ep / f"{k}.npz")[k] for k in ("observations", "actions", "gaze")},
            json.loads((ep / "stats.json").read_text()))


def jax_draws(seeds, steps, device):
    keys = jax.vmap(jax.random.PRNGKey)(np.asarray(seeds))
    return torch.from_numpy(np.array(rollout_draws(keys, steps))).to(device)


@functools.lru_cache(maxsize=None)
def runs(tmp):
    from pathlib import Path

    root = Path(tmp)
    assert jax_collect.main(ARGS + ["--out", str(root / "jax")]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(collect, "seed_draws", jax_draws)
        before = render_kernel.launches
        assert collect.main(ARGS + ["--out", str(root / "port")], device="cpu") == 0
        assert render_kernel.launches == before  # CPU tensors take the plain render
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return runs(str(tmp_path_factory.mktemp("collect")))


@pytest.mark.parametrize("seed", SEEDS)
def test_episode_matches_jax(root, seed):
    (want, want_stats), (got, got_stats) = episode(root / "jax", seed), episode(root / "port", seed)
    n = len(want["actions"])
    assert n > 0 and all(len(v) == n for v in got.values())
    assert got["observations"].dtype == np.uint8 and got["observations"].shape == (n, 180, 320, 3)
    d = np.abs(got["observations"].astype(np.int16) - want["observations"].astype(np.int16))
    assert (d > 0).mean() < 0.01 and np.median(d) == 0
    np.testing.assert_array_equal(got["actions"][:, 2:], want["actions"][:, 2:])
    np.testing.assert_allclose(got["actions"][:, :2], want["actions"][:, :2], rtol=0, atol=JIT_TOL)
    np.testing.assert_allclose(got["gaze"], want["gaze"], rtol=0, atol=1e-4)
    assert got_stats == want_stats
    # the expert drove: some throttle, and a valid road fixation
    assert (got["actions"][:, 0] > 0).any() and (got["gaze"][:, 0] >= 0).any()


def test_replay_round_trip(root, tmp_path):
    """Replaying seed 200's actions with its draws writes the same episode."""
    src = root / "port" / f"route_{ROUTE}" / "seed_200"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(collect, "seed_draws", jax_draws)
        collect.main(["--route", str(ROUTE), "--steps", str(STEPS), "--seeds", "200",
                      "--replay", str(src), "--video", "--out", str(tmp_path)], device="cpu")
    (want, want_stats), (got, got_stats) = episode(root / "port", 200), episode(tmp_path, 200)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_stats == want_stats
    from PIL import Image

    gif = Image.open(tmp_path / f"route_{ROUTE}" / "seed_200" / "episode.gif")
    assert gif.n_frames == len(want["actions"]) and gif.size == (320, 180)


def test_seed_draws_are_per_seed():
    """A seed's draws do not depend on the seeds beside it."""
    both = collect.seed_draws([3, 4], 5, "cpu")
    assert torch.equal(both[:, 1], collect.seed_draws([4], 5, "cpu")[:, 0])


def test_xosc_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        collect.main(["--xosc", "a.xosc", "--out", str(tmp_path)], device="cpu")
