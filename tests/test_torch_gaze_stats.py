"""Port parity for data/gaze_stats.py: sparsify, humanize and misperceive
against the JAX package's (numpy in both), bitwise, on the same dense
analytic-gaze rows [T, 10] and episode lengths, at the default seed and
another; each transform rewrites its input in place and returns it, in both
packages (the protocol passes the store's flat gaze buffer and relies on
that)."""

import numpy as np
import pytest

import gabril_carla_tpu.data.gaze_stats as J
import gabril_carla_tpu_torch.data.gaze_stats as P

LENGTHS = np.asarray([37, 120, 1, 64], np.int64)
CONSTANTS = ("BLANK_FRAC", "FIX_MEDIAN_S", "FIX_LOG_SIGMA", "FIX_MIN_S", "FIX_MAX_S",
             "SIGMA_LAND", "SIGMA_DRIFT", "P_LAPSE", "P_WRONG", "SIGMA_CONFUSE")


def dense_gaze(seed: int = 0) -> np.ndarray:
    """Analytic-gaze-shaped rows: a road point (invalid on a few frames),
    then four hazard-ranked actors, the lower ranks more often -1."""
    rng = np.random.default_rng(seed)
    t = int(LENGTHS.sum())
    pts = rng.random((t, 5, 2)).astype(np.float32)
    invalid = rng.random((t, 5)) < np.asarray([0.05, 0.3, 0.5, 0.7, 0.85])
    pts[invalid] = -1.0
    return pts.reshape(t, 10)


def test_constants_match_jax():
    for name in CONSTANTS:
        assert getattr(P, name) == getattr(J, name), name


TRANSFORMS = {
    "sparsify": lambda mod, g, lengths, seed: mod.sparsify_gaze_coords(g, seed=seed),
    "humanize": lambda mod, g, lengths, seed: mod.humanize_gaze_coords(g, lengths=lengths,
                                                                       seed=seed),
    "misperceive": lambda mod, g, lengths, seed: mod.misperceive_gaze_coords(
        g, lengths=lengths, seed=seed),
}


@pytest.mark.parametrize("lengths", [LENGTHS, None], ids=["episodes", "one_episode"])
@pytest.mark.parametrize("seed", [123, 200], ids=["default_seed", "seed200"])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_bitwise_and_in_place(name, seed, lengths):
    src = dense_gaze()
    want_in, got_in = src.copy(), src.copy()
    want = TRANSFORMS[name](J, want_in, lengths, seed)
    got = TRANSFORMS[name](P, got_in, lengths, seed)
    assert want is want_in and got is got_in  # in place, returned for chaining
    assert got.dtype == np.float32 and got.shape == src.shape
    np.testing.assert_array_equal(got, want)
    # one fixation in columns 0:2, the rest blanked; some frames dropped
    assert (got[:, 2:] == -1.0).all()
    assert 0.0 < (got[:, 0] < 0).mean() < 1.0


def test_defaults_match_jax():
    """Each transform called with its defaults only."""
    for fn in ("sparsify_gaze_coords", "humanize_gaze_coords", "misperceive_gaze_coords"):
        want, got = dense_gaze(1), dense_gaze(1)
        np.testing.assert_array_equal(getattr(P, fn)(got), getattr(J, fn)(want), err_msg=fn)


def test_views_of_a_flat_buffer_follow():
    """Episode arrays that are views of the flat buffer see the rewrite
    (EpisodeStore.finalize's layout)."""
    flat = dense_gaze()
    views = np.split(flat, np.cumsum(LENGTHS)[:-1])
    P.humanize_gaze_coords(flat, lengths=LENGTHS, seed=5)
    np.testing.assert_array_equal(np.concatenate(views), flat)
    assert all(np.shares_memory(v, flat) for v in views)
