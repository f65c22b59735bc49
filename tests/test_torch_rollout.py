"""Port parity for the slice as a whole (eval/rollout.py): world compile ->
render -> policy -> env step -> score, closed loop.

A 30-tick closed-loop rollout of three real routes with a small-width
float32 policy (converted flax parameters) and JAX's replayed draws, against
gabril_carla_tpu.eval.rollout.make_rollout_fn vmapped: the ego position
trace within 1e-3 m and the final scores within 1e-3; the same through
``rollout_routes`` with JAX's key and the port's own draws (utils/prng.py).
Also: the port runs with JAX made unimportable, and the rollout's contract
(launch-free on the CPU, warm-up no-ops, draws checked).
"""

import functools
import os
import subprocess
import sys
import textwrap

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
from gabril_carla_tpu.utils import default_bc_config
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.env.criteria import compute_score as port_score
from gabril_carla_tpu_torch.eval import rollout as PRO
from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default_bc_config
from gabril_carla_tpu_torch.utils.prng import prng_key, split
from test_torch_common import cpu_threads, port_spec

TICKS = 30
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def small_cfg(port=False):
    cfg = (port_default_bc_config if port else default_bc_config)()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = "float32"
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    return cfg


@functools.lru_cache(maxsize=None)
def jax_run():
    cfg = small_cfg()
    models = JB.build_bc_models(cfg)
    params = JB.init_bc_params(models, cfg, jax.random.PRNGKey(0))
    # a nudge so the untrained policy drives: throttle bias up
    params["actor"]["Dense_1"]["bias"] = params["actor"]["Dense_1"]["bias"].at[0].set(0.6)
    specs = jax.tree.map(jnp.asarray, load_benchmark_specs(None, seen_routes()[:3]))
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    fn = JRO.make_rollout_fn(JB.make_bc_policy_fn(models, cfg), cfg, steps=TICKS)
    st, trace = jax.jit(jax.vmap(fn, in_axes=(0, None, 0)))(specs, params, keys)
    return specs, keys, params, st, np.asarray(trace)


def port_policy(params):
    cfg = small_cfg(port=True)
    models = PB.build_bc_models(cfg, device="cpu")
    return cfg, PB.make_bc_policy_fn(models, cfg), convert.params_from_flax(
        jax.tree.map(np.asarray, params), cfg)


@functools.lru_cache(maxsize=None)
def port_keyed_run():
    """The port's rollout of jax_run's worlds called with its keys (JAX's
    keys: its draws): (final state, trace, K1 launches in the call)."""
    specs, keys, params, _, _ = jax_run()
    cfg, policy, state_dict = port_policy(params)
    fn = PRO.make_rollout_fn(policy, cfg, steps=TICKS)
    before = render_kernel.launches
    st, got = fn(port_spec(jax.tree.map(np.asarray, specs)), state_dict, np.asarray(keys))
    return st, got, render_kernel.launches - before


@functools.lru_cache(maxsize=None)
def port_routes_run():
    """rollout_routes over the same three routes on ``prng_key(5)``."""
    from gabril_carla_tpu_torch.env.world import load_benchmark_specs as port_specs

    cfg, policy, state_dict = port_policy(jax_run()[2])
    fn = PRO.make_rollout_fn(policy, cfg, steps=TICKS)
    return PRO.rollout_routes(port_specs(seen_routes()[:3]), state_dict, fn, prng_key(5),
                              device="cpu")


def test_closed_loop_matches_jax():
    specs, keys, params, ref, trace = jax_run()
    spec_p = port_spec(jax.tree.map(np.asarray, specs))
    st, got, launches = port_keyed_run()
    assert launches == 0  # CPU tensors take the plain version
    got = got.numpy().transpose(1, 0, 2)  # [B, T, 2] as JAX's trace
    assert np.abs(got - trace).max() < 1e-3
    assert np.abs(got[:, -1] - got[:, 0]).max() > 0.5  # the worlds moved
    want = jax.vmap(compute_score)(specs, ref)
    have = port_score(spec_p, st)
    for k in ("score_route", "score_penalty", "score_composed"):
        np.testing.assert_allclose(have[k].numpy(), np.asarray(want[k]), atol=1e-3, err_msg=k)


def test_rollout_routes_matches_jax():
    """rollout_routes(key=PRNGKey(5)) splits the key per world as JAX's
    rollout_routes does (JAX eval/rollout.py:153): the JAX run above,
    without replaying its draws. The rollout called with those keys,
    ``split(prng_key(5), 3)``, is rollout_routes bitwise, in float32 on the
    CPU: the final state and the trace."""
    from gabril_carla_tpu_torch.parallel.mesh import tree_leaves

    specs, keys, params, ref, trace = jax_run()
    st, got = port_routes_run()
    assert np.abs(got.numpy().transpose(1, 0, 2) - trace).max() < 1e-3
    want = jax.vmap(compute_score)(specs, ref)
    have = port_score(port_spec(jax.tree.map(np.asarray, specs)), st)
    for k in ("score_route", "score_penalty", "score_composed"):
        np.testing.assert_allclose(have[k].numpy(), np.asarray(want[k]), atol=1e-3, err_msg=k)
    assert port_policy(params)[0].training["compute_dtype"] == "float32"
    np.testing.assert_array_equal(np.asarray(keys), split(prng_key(5), 3))
    keyed_st, keyed_trace, _ = port_keyed_run()
    assert torch.equal(keyed_trace, got)
    leaves, want_leaves = tree_leaves(keyed_st), tree_leaves(st)
    assert len(leaves) == len(want_leaves) > 20
    for g, w in zip(leaves, want_leaves):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_rollout_routes_entry_and_warmup():
    """rollout_routes moves a numpy spec to the device; the first ticks are
    full-brake no-ops, so nothing moves during them."""
    cfg, policy, state_dict = port_policy(jax_run()[2])
    from gabril_carla_tpu_torch.env.world import load_benchmark_specs as port_specs

    fn = PRO.make_rollout_fn(policy, cfg, steps=PRO.WARMUP_STEPS)
    st, trace = PRO.rollout_routes(port_specs(seen_routes()[:2]), state_dict, fn, prng_key(0),
                                   device="cpu")
    assert trace.shape == (PRO.WARMUP_STEPS, 2, 2)
    assert torch.equal(trace[0], trace[-1]) and (st.ego.speed == 0).all()


def test_rollout_checks_draws():
    cfg, policy, state_dict = port_policy(jax_run()[2])
    fn = PRO.make_rollout_fn(policy, cfg, steps=3)
    spec = port_spec(jax.tree.map(np.asarray, jax_run()[0]))
    with pytest.raises(ValueError):
        fn(spec, state_dict, split(prng_key(0), 2))  # 2 keys for 3 worlds
    with pytest.raises(ValueError):
        fn(spec, state_dict, np.zeros((3, 4), np.uint32))  # not threefry keys
    with pytest.raises(ValueError):  # the confounded two-pass checks them too
        PRO.make_rollout_fn(policy, cfg, steps=3, confounded=True)(spec, state_dict,
                                                                   prng_key(0)[None])


def test_port_runs_without_jax():
    """In a fresh interpreter where jax and flax cannot be imported, every
    module of the port imports (the eval agent, CLIs, parallel/, utils/prng
    and dryrun included), a 3-tick CPU rollout runs, alone and on a
    one-rank gloo mesh, one CPU train step (Reg with GMD), one gaze-predictor
    step, a 2-tick ViSaRL rollout on analytic gaze, an xosc storyboard's
    compile and a gaze-statistics transform, a batch through the native
    gather, a HumanLoop tick and save, a profile_trace window, visualize's
    panels and the route-table dispatch; no module of the JAX package gets
    loaded, and not its native library."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
            sys.modules[name] = None
        import torch
        import gabril_carla_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from gabril_carla_tpu_torch.env.world import load_benchmark_specs
        from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn, rollout_routes
        from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params, make_bc_policy_fn
        from gabril_carla_tpu_torch.utils.config import default_bc_config
        cfg = default_bc_config()
        cfg["gaze"]["method"] = "None"
        cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
        models = build_bc_models(cfg, device="cpu")
        from gabril_carla_tpu_torch.utils.prng import prng_key
        params = init_bc_params(models, cfg, prng_key(0))
        fn = make_rollout_fn(make_bc_policy_fn(models, cfg), cfg, steps=3)
        st, trace = rollout_routes(load_benchmark_specs([3100]), params, fn, prng_key(0), device="cpu")
        assert trace.shape == (3, 1, 2) and bool(torch.isfinite(trace).all())
        import tempfile
        import torch.distributed as dist
        from gabril_carla_tpu_torch.parallel import make_mesh
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=0, world_size=1)
            st1, trace1 = rollout_routes(load_benchmark_specs([3100]), params, fn, prng_key(0),
                                         device="cpu", mesh=make_mesh(device="cpu"))
            dist.destroy_process_group()
        assert torch.equal(trace1, trace) and torch.equal(st1.ego.pos, st.ego.pos)
        from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
        from gabril_carla_tpu_torch.train.bc import init_bc_state, make_bc_train_step
        from gabril_carla_tpu_torch.train.optim import build_optimizer
        cfg["gaze"]["method"], cfg["dropout"]["method"] = "Reg", "GMD"
        cfg["data"].update(img_height=24, img_width=48)
        tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, 2)
        models, state = init_bc_state(cfg, prng_key(0), tx, device="cpu")
        ds = BCDataset(synthetic_episodes(n_demos=1, steps=4, img_hw=(24, 48)), frame_stack=2)
        batch = {k: torch.from_numpy(v) for k, v in ds.sample([0, 1, 2, 3]).items()}
        new, metrics = make_bc_train_step(models, cfg)(state, batch, prng_key(1))
        assert new.step == 1 and bool(torch.isfinite(metrics["loss"])) and float(metrics["loss_reg"]) > 0
        from gabril_carla_tpu_torch.cli import eval_routes
        from gabril_carla_tpu_torch.eval.agent import BCAgent
        from gabril_carla_tpu_torch.train.gaze_predictor import init_gaze_state, make_gaze_train_step
        from gabril_carla_tpu_torch.utils.config import default_gaze_config
        gcfg = default_gaze_config()
        gcfg["model"].update(num_hiddens=8, embedding_dim=4, num_residual_layers=1,
                             num_residual_hiddens=4)
        gcfg["training"]["compute_dtype"] = "float32"
        tx = build_optimizer(gcfg.optimizer, gcfg.scheduler, gcfg.training, 2)
        (model, hm), gstate = init_gaze_state(gcfg, prng_key(0), tx, device="cpu")
        ds = BCDataset(synthetic_episodes(n_demos=1, steps=2, img_hw=(180, 320)), frame_stack=2)
        batch = {k: torch.from_numpy(v) for k, v in ds.sample([0, 1]).items()}
        gnew, gm = make_gaze_train_step(model, hm, gcfg)(gstate, batch)
        assert gnew.step == 1 and bool(torch.isfinite(gm["loss"]))
        cfg["gaze"]["method"], cfg["dropout"]["method"] = "ViSaRL", "None"
        cfg["data"].update(img_height=180, img_width=320)
        models = build_bc_models(cfg, device="cpu")
        params = init_bc_params(models, cfg, prng_key(0))
        fn = make_rollout_fn(make_bc_policy_fn(models, cfg), cfg, steps=2, use_analytic_gaze=True)
        st, trace = rollout_routes(load_benchmark_specs([3100]), params, fn, prng_key(1), device="cpu")
        assert bool(torch.isfinite(trace).all())
        from gabril_carla_tpu_torch.data.gaze_stats import humanize_gaze_coords
        from gabril_carla_tpu_torch.data.vendored import xosc_example
        from gabril_carla_tpu_torch.env.world import build_world_spec
        from gabril_carla_tpu_torch.env.xosc import load_xosc
        assert build_world_spec(load_xosc(xosc_example("CyclistCrossing.xosc"))).route_len > 50
        assert humanize_gaze_coords(torch.rand(20, 10).numpy()).shape == (20, 10)
        import numpy as np
        from gabril_carla_tpu_torch import native
        from gabril_carla_tpu_torch.cli.visualize import panels
        from gabril_carla_tpu_torch.data.vendored import routes_path
        from gabril_carla_tpu_torch.env.world import parse_routes
        from gabril_carla_tpu_torch.eval.human import HumanLoop
        from gabril_carla_tpu_torch.utils.profiling import profile_trace
        ds = BCDataset(synthetic_episodes(n_demos=1, steps=3, img_hw=(24, 48)), frame_stack=2)
        assert ds._native is native and ds.sample([0, 2])["obs_seq"].shape == (2, 2, 24, 48, 3)
        with tempfile.TemporaryDirectory() as tmp:
            loop = HumanLoop(load_benchmark_specs([3100]), tmp, gaze="dummy", device="cpu")
            loop.start(200)
            with profile_trace(tmp + "/trace"):
                loop.tick(np.array([0.8, 0, 0, 0, 0, 0, 0], np.float32), loop.gaze.sample())
            assert (loop.save() / "stats.json").exists()
        heat, tri = panels(np.zeros((2, 180, 320, 3), np.uint8), np.full((2, 10), 0.5, np.float32),
                           device="cpu")
        assert heat.shape == (2, 180, 320) and tri.shape == (2, 180, 960, 3)
        assert list(parse_routes(routes_path(), [3100])) == [3100]
        maps = open("/proc/self/maps").read()
        assert "libgather_" in maps and "gabril_carla_tpu/native/" not in maps
        bad = [m for m in sys.modules if m == "gabril_carla_tpu" or m.startswith("gabril_carla_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
