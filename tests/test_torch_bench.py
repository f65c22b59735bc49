"""Port parity for the measuring entry points gabril_carla_tpu_torch.bench
and .bench_train against the JAX repo's bench.py and bench_train.py.

bench.py's ``main`` is one function that cannot be imported in parts, so
its pieces are rebuilt here from its lines with the JAX package's own
functions and held against the port's:
- the worlds (bench.py:73-98): 25 real worlds (the 20 routes tiled and cut)
  and 3 synthetic ones, bitwise;
- the loop (bench.py:160-205, its tuple ring, no packing), jitted over a
  vmapped step as bench.py runs it: 3 real routes, 30 ticks, a small-width
  float32 policy with tests/test_torch_rollout.py's throttle nudge, keys
  ``split(PRNGKey(5), 3)``; the final ego positions within 1e-3 m (the
  closed-loop bar of tests/test_torch_rollout.py), alone and under
  ``skip_policy`` and ``skip_render``; and in bf16, as the entry point
  runs it, each of 4 ticks' stacked obs and action (bars in
  test_bench_loop_bf16_matches_jax);
- bench_train.py's two first steps (warm-up key PRNGKey(1), then
  ``fold_in(PRNGKey(1), 0)``) from ``init_bc_state(PRNGKey(0))`` on its
  numpy batch, at 24x48, hiddens 16, batch 4, float32: metrics rtol 1e-5,
  parameters atol 2e-5 (tests/test_torch_trainer.py:
  test_epoch_matches_jax_epoch's bars);
- the peak table behind ``mfu_pct``.

The command lines are held in tests/test_torch_bench_cli.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.data.tasks import seen_routes, unseen_routes
from gabril_carla_tpu.env import DrivingEnv as JDrivingEnv
from gabril_carla_tpu.env.world import build_world_spec, load_benchmark_specs, stack_specs
from gabril_carla_tpu.ops.raster import render_frame as j_render_frame
from gabril_carla_tpu.train.optim import build_optimizer as j_build_optimizer
from gabril_carla_tpu.utils import default_bc_config
from gabril_carla_tpu_torch import bench as PBENCH
from gabril_carla_tpu_torch import bench_train as PBT
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.env.world import WorldSpec
from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default_bc_config
from gabril_carla_tpu_torch.utils.prng import prng_key, split
from test_torch_common import cpu_threads, port_spec

TICKS = 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def assert_specs_equal(port, want):
    for f in WorldSpec.__dataclass_fields__:
        got, ref = getattr(port, f).numpy(), np.asarray(getattr(want, f))
        assert got.dtype == ref.dtype and got.shape == ref.shape, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def test_real_worlds_bitwise():
    """bench.py:76-81: the 20 routes, tiled ceil(n / 20) times and cut to
    n; 25 worlds hold the cut."""
    n = 25
    ids = seen_routes() + unseen_routes()
    base = load_benchmark_specs(None, ids)
    reps = -(-n // len(ids))
    want = jax.tree.map(lambda a: np.concatenate([a] * reps)[:n], base)
    assert_specs_equal(PBENCH.bench_worlds(n, False, "cpu"), want)


def test_synthetic_worlds_bitwise():
    """bench.py:82-98, rebuilt with the JAX package's build_world_spec and
    stack_specs."""
    rng = np.random.default_rng(0)
    specs = []
    for i in range(3):
        t = np.linspace(0, 2 * np.pi, 150)
        curve = 30.0 * rng.standard_normal()
        wps = np.stack([300.0 * t / (2 * np.pi), curve * np.sin(t)], 1).astype(np.float32)
        specs.append(build_world_spec(
            {"id": i, "town": "T", "waypoints": wps,
             "scenarios": [{"type": "PedestrianCrossing", "trigger": (float(wps[20, 0]), float(wps[20, 1]), 0.0)}],
             "weather": [0, 0, 0, 90]}))
    assert_specs_equal(PBENCH.bench_worlds(3, True, "cpu"), stack_specs(specs))


def small_cfg(port=False, dtype="float32"):
    cfg = (port_default_bc_config if port else default_bc_config)()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = dtype
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    return cfg


def jax_bench_run(policy, cfg, n_steps, skip_policy, skip_render, trace=False):
    """bench.py:160-205 with the tuple ring and no carry packing; with
    ``trace``, also each tick's stacked obs and action."""
    env = JDrivingEnv()
    s = cfg.data["frame_stack"]
    fdt = jnp.bfloat16 if cfg["training"]["compute_dtype"] == "bfloat16" else jnp.float32

    def one_world_step(spec, state, frames, params):
        if skip_render:
            frame = jnp.full((180, 320), jnp.sum(state.ego.pos) * 1e-6, fdt)
        else:
            frame = j_render_frame(spec, state).astype(fdt)
        frames = frames[1:] + (frame,)
        obs = jnp.stack(frames, axis=-1)
        if skip_policy:
            action = jnp.array([0.3, 0.0, 0.0]) + 1e-9 * obs[0, 0, 0]
        else:
            action = policy(params, obs[None])[0]
        state = env.step(spec, state, action)
        return state, frames, obs, action

    def run(specs, params, keys):
        states = jax.vmap(env.reset)(specs, keys)
        frames0 = tuple(jnp.zeros((keys.shape[0], 180, 320), fdt) for _ in range(s))

        def body(carry, _):
            st, fr = carry
            st, fr, obs, action = jax.vmap(one_world_step, in_axes=(0, 0, 0, None))(specs, st, fr, params)
            return (st, fr), ((obs, action) if trace else None)

        (states, _), ys = jax.lax.scan(body, (states, frames0), None, length=n_steps)
        return (states.ego.pos, *ys) if trace else states.ego.pos

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def jax_setup(dtype="float32"):
    cfg = small_cfg(dtype=dtype)
    models = JB.build_bc_models(cfg)
    params = JB.init_bc_params(models, cfg, jax.random.PRNGKey(0))
    # a nudge so the untrained policy drives: throttle bias up
    params["actor"]["Dense_1"]["bias"] = params["actor"]["Dense_1"]["bias"].at[0].set(0.6)
    specs = jax.tree.map(jnp.asarray, load_benchmark_specs(None, seen_routes()[:3]))
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    return cfg, models, params, specs, keys


@functools.lru_cache(maxsize=None)
def jax_final_pos(skip_policy, skip_render):
    cfg, models, params, specs, keys = jax_setup()
    run = jax_bench_run(JB.make_bc_policy_fn(models, cfg), cfg, TICKS, skip_policy, skip_render)
    return np.asarray(run(specs, params, keys))


@pytest.mark.parametrize("skip_policy,skip_render", [(False, False), (True, False), (False, True)],
                         ids=["full", "skip_policy", "skip_render"])
def test_bench_loop_matches_jax(skip_policy, skip_render):
    _, _, params, specs, keys = jax_setup()
    want = jax_final_pos(skip_policy, skip_render)
    cfg = small_cfg(port=True)
    models = PB.build_bc_models(cfg, device="cpu")
    state_dict = convert.params_from_flax(jax.tree.map(np.asarray, params), cfg)
    run = PBENCH.make_bench_run(PB.make_bc_policy_fn(models, cfg), cfg, TICKS, skip_policy, skip_render)
    np.testing.assert_array_equal(np.asarray(keys), split(prng_key(5), 3))
    spec0 = port_spec(jax.tree.map(np.asarray, specs))
    before = render_kernel.launches
    got = run(spec0, state_dict, split(prng_key(5), 3))
    assert render_kernel.launches == before  # CPU tensors take the plain version
    assert got.shape == (3, 2) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-3
    start = spec0.spawn_pos.numpy()
    assert np.abs(want - start).max() > 0.5  # the worlds moved


BF16_TICKS = 4


@functools.lru_cache(maxsize=None)
def jax_bf16_trace():
    cfg, models, params, specs, keys = jax_setup("bfloat16")
    run = jax_bench_run(JB.make_bc_policy_fn(models, cfg), cfg, BF16_TICKS, False, False, trace=True)
    return tuple(np.asarray(x) for x in run(specs, params, keys))


def test_bench_loop_bf16_matches_jax():
    """The loop as the entry point runs it, ring and policy in bf16, over
    BF16_TICKS ticks against the JAX rebuild's:
    - each tick's stacked obs [B, H, W, S] is bf16 in the ring's order and
      bitwise JAX's but for under 0.1% of its pixels (measured 3 of
      345,600): the plain render and JAX's differ there by float32
      rounding at an argmin's near tie (tests/test_torch_render.py:
      assert_frames_match), which moves a pixel by up to a class's shade;
    - the port's policy on JAX's obs: test_torch_policy.py's bf16 bar, 1%
      of the logits' scale (measured 0.31%);
    - the loop's own actions: 2% of that scale, the bf16 bar plus those
      few pixels, which enter the first conv at full weight (measured
      1.1% at tick 0, 0.22% after);
    - the final ego positions within 1e-3 m."""
    _, _, params, specs, keys = jax_setup("bfloat16")
    want_pos, want_obs, want_act = jax_bf16_trace()
    cfg = small_cfg(port=True, dtype="bfloat16")
    models = PB.build_bc_models(cfg, device="cpu")
    policy = PB.make_bc_policy_fn(models, cfg)
    seen = []

    def recording(p, obs):
        action = policy(p, obs)
        seen.append((obs.clone(), action.clone()))
        return action

    state_dict = convert.params_from_flax(jax.tree.map(np.asarray, params), cfg)
    run = PBENCH.make_bench_run(recording, cfg, BF16_TICKS)
    pos = run(port_spec(jax.tree.map(np.asarray, specs)), state_dict, split(prng_key(5), 3))
    assert len(seen) == BF16_TICKS
    assert not want_obs[0, ..., 0].astype(np.float32).any()  # the ring starts at zero
    scale = np.abs(want_act).max()
    for t, (obs, action) in enumerate(seen):
        assert obs.dtype == torch.bfloat16 and obs.shape == want_obs[t].shape
        ref = want_obs[t].astype(np.float32)
        assert (obs.float().numpy() != ref).mean() < 1e-3, t
        on_jax_obs = policy(state_dict, torch.from_numpy(ref).to(torch.bfloat16))
        np.testing.assert_allclose(on_jax_obs.numpy(), want_act[t], atol=0.01 * scale, rtol=0, err_msg=str(t))
        np.testing.assert_allclose(action.numpy(), want_act[t], atol=0.02 * scale, rtol=0, err_msg=str(t))
    assert np.abs(pos.numpy() - want_pos).max() < 1e-3


def test_bench_run_checks_keys():
    cfg = small_cfg(port=True)
    run = PBENCH.make_bench_run(lambda p, obs: None, cfg, 2, skip_policy=True)
    spec = PBENCH.bench_worlds(3, True, "cpu")
    with pytest.raises(ValueError):
        run(spec, {}, split(prng_key(0), 2))  # 2 keys for 3 worlds


# --- bench_train.py ------------------------------------------------------------

# the cut to the CPU tests' size; the saliency temperature (gaze.beta) 1,
# not 50, as tests/test_torch_common.py: bc_cfgs says why (at 24x48 the
# min-max mask divides float32 rounding by a tiny max - min at 50)
TRAIN_OVER = {"data": dict(img_height=24, img_width=48),
              "model": dict(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                            num_residual_hiddens=8, z_dim=16),
              "gaze": dict(beta=1.0),
              "training": dict(compute_dtype="float32")}


def train_cfgs():
    """(JAX, port): bench_train.py:62-65's configuration at batch 4, then
    cut to 24x48, hiddens 16, saliency temperature 1 and float32."""
    jcfg = default_bc_config()
    jcfg["data"].update(batch_size=4)
    jcfg["gaze"].update(method="Reg", mask_sigma=30.0)
    jcfg["training"].update(compute_dtype="bfloat16", donate=True)
    pcfg = PBT.bench_train_cfg(4)
    for cfg in (jcfg, pcfg):
        for k, v in TRAIN_OVER.items():
            cfg[k].update(v)
    return jcfg, pcfg


def script_batch(cfg, bs):
    """bench_train.py:74-81's batch, as numpy."""
    s = cfg.data["frame_stack"]
    h, w = cfg.data["img_height"], cfg.data["img_width"]
    p = cfg.gaze["max_points"]
    host = np.random.default_rng(0)
    return {"obs_seq": host.integers(0, 255, (bs, s, h, w, 1), dtype=np.uint8),
            "gaze_seq": host.random((bs, s, p * 2), dtype=np.float32),
            "actions": host.random((bs, cfg.data["action_dim"]), dtype=np.float32)}


def test_bench_train_steps_match_jax():
    jcfg, pcfg = train_cfgs()
    batch = script_batch(jcfg, 4)
    port_batch = PBT.bench_batch(pcfg, 4, "cpu")
    assert set(port_batch) == set(batch)
    for k, v in batch.items():
        np.testing.assert_array_equal(port_batch[k].numpy(), v, err_msg=k)

    tx = j_build_optimizer(jcfg.optimizer, jcfg.scheduler, jcfg.training, steps_per_epoch=100)
    jmodels, jstate = JB.init_bc_state(jcfg, jax.random.PRNGKey(0), tx)
    jstep = JB.make_bc_train_step(jmodels, jcfg, donate=False, jit=True)
    key = jax.random.PRNGKey(1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jstate, _ = jstep(jstate, jbatch, key)
    jstate, jmetrics = jstep(jstate, jbatch, jax.random.fold_in(key, 0))

    np.testing.assert_array_equal(PBT.KEY, np.asarray(key))
    np.testing.assert_array_equal(PBT.timed_keys(2), [np.asarray(jax.random.fold_in(key, i)) for i in range(2)])
    models, state = PBT.bench_train_state(pcfg, "cpu")
    step = PB.make_bc_train_step(models, pcfg)
    state, _ = step(state, port_batch, PBT.KEY)
    state, metrics = step(state, port_batch, PBT.timed_keys(1)[0])

    assert state.step == 2
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params), pcfg)
    assert set(want) == set(state.params)
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=k)


def test_peak_lookup():
    assert PBT.PEAK_BF16.get("NVIDIA H100 80GB HBM3") == 989e12
    assert PBT.PEAK_BF16.get("NVIDIA GeForce GTX 1080") is None
    assert PBT.PEAK_BF16.get("cpu") is None
