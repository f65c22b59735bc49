"""Port parity for the gaze-heat eval path (eval/rollout.py): closed-loop
rollouts whose policy consumes heat, against the JAX package's
make_rollout_fn vmapped, on JAX's replayed draws.

Three cases, at tests/test_torch_rollout.py's bars (the ego position trace
within 1e-3 m, the final scores within 1e-3): ViSaRL with analytic gaze
here; Mask with a frozen AutoEncoder predictor (flax parameters converted)
and the confounded two-pass with gaze None in
tests/test_torch_rollout_heat_predictor.py, so that the three JAX compiles
spread over two test workers. Small widths, float32, two real
routes, TICKS ticks. Also the ports of tests/test_rollout.py:54-134: the
refusal of a heat-needing method with no heat source, the clamp of the
predictor's output, and the ring buffer that keeps the overlaid frames.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.eval.rollout as JRO
import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.data.tasks import seen_routes
from gabril_carla_tpu.env.criteria import compute_score
from gabril_carla_tpu.env.world import load_benchmark_specs
from gabril_carla_tpu.models import AutoEncoder as JAutoEncoder
from gabril_carla_tpu.utils import default_bc_config
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.env.criteria import compute_score as port_score
from gabril_carla_tpu_torch.env.world import build_world_spec, stack_specs, to_torch
from gabril_carla_tpu_torch.eval import rollout as PRO
from gabril_carla_tpu_torch.ops.raster import confounded_overlay
from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.train.gaze_predictor import build_gaze_models, make_gaze_predictor_apply
from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default_bc_config
from gabril_carla_tpu_torch.utils.prng import prng_key, split
from test_torch_common import cpu_threads, port_spec

TICKS = 20
CASES = {"visarl_analytic": ("ViSaRL", dict(use_analytic_gaze=True)),
         "mask_predictor": ("Mask", {}),
         "confounded": ("None", dict(confounded=True))}
GP = dict(embedding_dim=4, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def small_cfg(method, port=False):
    cfg = (port_default_bc_config if port else default_bc_config)()
    cfg["gaze"].update(method=method, mask_sigma=10.0)
    cfg["training"]["compute_dtype"] = "float32"
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    return cfg


@functools.lru_cache(maxsize=None)
def jax_run(case):
    method, kw = CASES[case]
    cfg = small_cfg(method)
    models = JB.build_bc_models(cfg)
    params = JB.init_bc_params(models, cfg, jax.random.PRNGKey(0))
    # a nudge so the untrained policy drives: throttle bias up
    params["actor"]["Dense_1"]["bias"] = params["actor"]["Dense_1"]["bias"].at[0].set(0.6)
    if case == "mask_predictor":
        ae = JAutoEncoder(out_channels=1, **GP)
        params["gaze_predictor"] = ae.init(jax.random.PRNGKey(3), jnp.zeros((1, 180, 320, 2)))["params"]
        kw = dict(gaze_predictor_apply=lambda p, obs: ae.apply({"params": p}, obs))
    specs = jax.tree.map(jnp.asarray, load_benchmark_specs(None, seen_routes()[3:5]))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    pol = JB.make_bc_policy_fn(models, cfg)
    fn = JRO.make_rollout_fn(lambda p, o, h=None: pol(p, o, h), cfg, steps=TICKS, **kw)
    st, trace = jax.jit(jax.vmap(fn, in_axes=(0, None, 0)))(specs, params, keys)
    return specs, keys, jax.tree.map(np.asarray, params), st, np.asarray(trace)


def port_setup(case, params):
    """(rollout fn, state dict) of the port for ``case``'s JAX run."""
    method, kw = CASES[case]
    cfg = small_cfg(method, port=True)
    models = PB.build_bc_models(cfg, device="cpu")
    sd = convert.params_from_flax({k: v for k, v in params.items() if k != "gaze_predictor"}, cfg)
    if case == "mask_predictor":
        gcfg = port_default_bc_config()
        gcfg["model"].update(**GP)
        gcfg["training"]["compute_dtype"] = "float32"
        model, _ = build_gaze_models(gcfg, device="cpu")
        sd["gaze_predictor"] = convert.gaze_params_from_flax(params["gaze_predictor"], gcfg)
        kw = dict(gaze_predictor_apply=make_gaze_predictor_apply(model))
    return PRO.make_rollout_fn(PB.make_bc_policy_fn(models, cfg), cfg, steps=TICKS, **kw), sd


def check_against_jax(case):
    """``case``'s port rollout against its JAX run, at the bars above."""
    specs, keys, params, ref, trace = jax_run(case)
    fn, sd = port_setup(case, params)
    spec_p = port_spec(jax.tree.map(np.asarray, specs))
    before = render_kernel.launches
    st, got = fn(spec_p, sd, np.asarray(keys))  # JAX's keys: its draws
    assert render_kernel.launches == before  # CPU tensors take the plain version
    got = got.numpy().transpose(1, 0, 2)  # [B, T, 2] as JAX's trace
    assert np.abs(got - trace).max() < 1e-3
    assert np.abs(got[:, -1] - got[:, 0]).max() > 0.1  # the worlds moved
    want = jax.vmap(compute_score)(specs, ref)
    have = port_score(spec_p, st)
    for k in ("score_route", "score_penalty", "score_composed"):
        np.testing.assert_allclose(have[k].numpy(), np.asarray(want[k]), atol=1e-3, err_msg=k)


def test_heat_rollout_matches_jax():
    """ViSaRL on analytic gaze (the other two cases are in
    tests/test_torch_rollout_heat_predictor.py, which runs in parallel)."""
    check_against_jax("visarl_analytic")


def spec_straight():
    wps = np.stack([np.arange(0.0, 120, 2.0), np.zeros(60)], 1).astype(np.float32)
    return to_torch(stack_specs([build_world_spec(
        {"id": 5, "town": "T", "waypoints": wps,
         "scenarios": [{"type": "PedestrianCrossing", "trigger": (30.0, 0.0, 0.0)}],
         "weather": [0, 0, 0, 90]})]), "cpu")


def tiny(method):
    cfg = port_default_bc_config()
    cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1,
                        num_residual_hiddens=4, z_dim=8)
    cfg["gaze"].update(method=method, mask_sigma=10.0)
    cfg["training"]["compute_dtype"] = "float32"
    models = PB.build_bc_models(cfg, device="cpu")
    params = PB.init_bc_params(models, cfg, prng_key(0))
    return cfg, PB.make_bc_policy_fn(models, cfg), params


@pytest.mark.parametrize("method", ["Mask", "AGIL", "ViSaRL"])
def test_heat_needing_method_without_source_fails_loudly(method):
    """No predictor and no analytic gaze: refuse rather than drive on zero
    heat (an all-black Mask input)."""
    cfg, policy, _ = tiny(method)
    with pytest.raises(ValueError, match="needs gaze heat"):
        PRO.make_rollout_fn(policy, cfg)
    cfg["gaze"]["method"], cfg["dropout"]["method"] = "None", "GMD"
    with pytest.raises(ValueError, match="needs gaze heat"):
        PRO.make_rollout_fn(policy, cfg)


def test_predicted_heat_is_clamped():
    """An unbounded predictor output is clamped to [0, 1] (bc_agent.py:277)."""
    cfg, _, params = tiny("Mask")
    params["gaze_predictor"] = {}
    spec = spec_straight()

    def probe_policy(p, obs, heat=None):  # steers by the heat it is given
        act = torch.zeros(obs.shape[0], 7)
        act[:, 0] = 1.0
        act[:, 1] = (heat.mean(dim=(1, 2, 3)) - 1.0) * 5.0
        return act

    def run_with(value):
        fake = lambda p, obs: torch.full(obs.shape[:3] + (1,), value)
        fn = PRO.make_rollout_fn(probe_policy, cfg, steps=25, gaze_predictor_apply=fake)
        return fn(spec, params, split(prng_key(0), 1))[1].numpy()

    at_one = run_with(1.0)
    np.testing.assert_array_equal(run_with(7.5), at_one)
    assert not np.array_equal(run_with(0.5), at_one)


def test_confounded_ring_buffer_keeps_historical_overlays():
    """The second pass sees the newest frame overlaid with the first pass's
    action, and the next tick's stack keeps that overlaid frame
    (bc_agent.py:228-269)."""
    cfg, policy, params = tiny("None")
    seen = []

    def probe_policy(p, obs, heat=None):
        act = policy(p, obs, heat)
        seen.append((obs, act))
        return act

    fn = PRO.make_rollout_fn(probe_policy, cfg, steps=3, confounded=True)
    fn(spec_straight(), params, split(prng_key(0), 1))
    assert len(seen) == 6  # two passes a tick
    for t in range(3):
        (raw, a1), (ov, _) = seen[2 * t], seen[2 * t + 1]
        assert torch.equal(ov[..., -1], confounded_overlay(raw[..., -1], a1))
        assert torch.equal(ov[..., :-1], raw[..., :-1])
        if t:
            assert torch.equal(raw[..., -2], seen[2 * t - 1][0][..., -1])
