"""Helpers shared by the port's parity tests (tests/test_torch_*.py): moving
specs and scene states from the JAX package to the port, replaying JAX's
per-step random draws, comparing state trees; for BC training, the two
packages' equal small configurations, a shared batch, JAX's train-step
draws and a gradient comparison. It holds no tests.

Data crosses between the two frameworks as numpy arrays; JAX runs on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.env import state as PS
from gabril_carla_tpu_torch.env.world import WorldSpec, to_torch
from gabril_carla_tpu_torch.train import bc as PB

POOLS = {"ego": PS.EgoState, "vehicles": PS.ActorPool, "walkers": PS.WalkerPool,
         "statics": PS.StaticPool, "scenario": PS.ScenarioState, "criteria": PS.Criteria}


@contextlib.contextmanager
def cpu_threads(n: int):
    """Torch's CPU thread pool at ``n`` threads inside the block. The Tier-1
    command runs six test workers on the host's cores; at the small sizes of
    these tests, eight intra-op threads a worker only wait on each other
    (a 2 s test file took 240 s that way), so the slice-5 files run on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def port_spec(spec) -> WorldSpec:
    """A batched JAX WorldSpec (leading world axis) as the port's, on the CPU."""
    return to_torch(WorldSpec(**{f.name: np.asarray(getattr(spec, f.name))
                                 for f in dataclasses.fields(WorldSpec)}), "cpu")


def port_state(st) -> PS.SceneState:
    """A batched JAX SceneState as the port's (its PRNG key has no
    counterpart: the port takes draws per step)."""
    def leaves(cls, src):
        return cls(**{f.name: torch.from_numpy(np.array(getattr(src, f.name)))
                      for f in dataclasses.fields(cls)})

    return PS.SceneState(**{k: leaves(cls, getattr(st, k)) for k, cls in POOLS.items()},
                         t=torch.from_numpy(np.array(st.t)), done=torch.from_numpy(np.array(st.done)))


def state_leaves(st) -> dict:
    """{'pool.field': numpy array} of a JAX or port SceneState."""
    out = {"t": np.asarray(st.t), "done": np.asarray(st.done)}
    for k, cls in POOLS.items():
        for f in dataclasses.fields(cls):
            out[f"{k}.{f.name}"] = np.asarray(getattr(getattr(st, k), f.name))
    return out


def assert_states_close(jax_st, port_st, rtol=1e-5, atol=1e-5, rows=slice(None)):
    """Integer and bool leaves equal; float leaves within rtol/atol (relative:
    world coordinates reach a few thousand metres, where one f32 ulp is
    ~5e-4). ``rows`` picks worlds."""
    a, b = state_leaves(jax_st), state_leaves(port_st)
    for k in a:
        x, y = a[k][rows], b[k][rows]
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape, x.dtype, y.dtype)
        if x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


def _one_step_draws(sub):
    s, s_amb = jax.random.split(sub)
    kf = jax.random.split(s, 2)
    k_same, k_opp = jax.random.split(s_amb)
    return jnp.stack([jax.random.uniform(k, ()) for k in (kf[0], kf[1], k_same, k_opp)])


_step_draws = jax.jit(jax.vmap(_one_step_draws))


def step_draws(subs) -> np.ndarray:
    """[B, 4] uniforms of one env step per world, from the step keys ``subs``
    [B] exactly as the JAX step splits them (env.py:117-123,
    scenarios.py:51,65, ambient.py:111): flow 0, flow 1, ambient same,
    ambient opposite."""
    return np.asarray(_step_draws(subs))


def rollout_draws(reset_keys, steps: int) -> np.ndarray:
    """[steps, B, 4] draws of a JAX rollout whose worlds were reset with
    ``reset_keys`` [B] and stepped with key=None (each step splits
    state.rng into the next rng and the step key)."""
    def body(rng, _):
        pair = jax.vmap(jax.random.split)(rng)
        return pair[:, 0], _step_draws(pair[:, 1])

    return np.asarray(jax.lax.scan(body, reset_keys, None, length=steps)[1])


# --- BC training (tests/test_torch_train*.py, test_torch_trainer.py) -------

BC_H, BC_W, BC_P, BC_A, BC_S = 24, 48, 3, 7, 2  # tests/test_train_bc.py's size


def bc_cfgs(gaze: str = "None", dropout: str = "None", **over):
    """(JAX config, port config), equal: tests/test_train_bc.py's small BC
    configuration at 24x48, float32, with dotted ``over``rides.

    The saliency temperature is 1, not 50: this encoder's latent is 1x4 and
    its saliency sums are small, so at 50 the softmax is nearly flat and the
    mask's min-max normalization divides float32 rounding by the tiny
    max - min (measured gaps up to 9e-4 of the gradient scale at 50, 2e-5
    at 1). test_torch_train.py: test_bf16_reg_step_matches runs 50."""
    from gabril_carla_tpu.utils import default_bc_config
    from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default

    out = []
    for make in (default_bc_config, port_default):
        cfg = make()
        cfg["data"].update(img_height=BC_H, img_width=BC_W, frame_stack=BC_S, action_dim=BC_A,
                           batch_size=4)
        cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                            num_residual_hiddens=8, z_dim=16)
        cfg["gaze"].update(method=gaze, max_points=BC_P, mask_sigma=4.0, beta=1.0)
        cfg["dropout"].update(method=dropout, num_embeddings=16, oreo_num_mask=2)
        cfg["training"].update(compute_dtype="float32", epochs=1)
        cfg["scheduler"]["type"] = "none"
        for k, v in over.items():
            cfg.set_path(k, v)
        out.append(cfg)
    return tuple(out)


def bc_batch(n: int = 4, seed: int = 0, hw=(BC_H, BC_W), max_points=BC_P) -> dict:
    """A numpy batch from the JAX package's synthetic episodes and sampler."""
    from gabril_carla_tpu.data import BCDataset, synthetic_episodes

    store = synthetic_episodes(n_demos=1, steps=max(8, n), img_hw=hw, max_points=max_points,
                               action_dim=BC_A, seed=seed)
    return next(BCDataset(store, frame_stack=BC_S, use_native=False).iter_batches(
        n, np.random.default_rng(seed)))


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class _DropoutKeys(fnn.Module):
    """Two make_rng("dropout") calls at the root scope: the keys the JAX
    encoder's two IGMD dropouts draw with (models/encoder.py:81, :86)."""

    def __call__(self):
        return self.make_rng("dropout"), self.make_rng("dropout")


def nchw(a) -> torch.Tensor:
    """A JAX NHWC array as an NCHW tensor."""
    return torch.from_numpy(np.transpose(np.asarray(a), (0, 3, 1, 2)).copy())


def jax_bc_draws(cfg, key, bsz: int) -> dict:
    """The draws bc_loss_fn(..., key, train=True) of the JAX package makes
    (bc.py:222: split(key, 4) -> ivg, GMD, IGMD, Oreo), as the port's draws
    dict (train/bc.py): NCHW uniforms and Oreo's code mask."""
    _, k_gmd, k_igmd, k_oreo = jax.random.split(key, 4)
    d = cfg.dropout["method"]
    h, w = cfg.data["img_height"], cfg.data["img_width"]
    out = {}
    if d == "IGMD":
        keys = _DropoutKeys().apply({}, rngs={"dropout": k_igmd})
        out["igmd"] = [nchw(jax.random.uniform(k, (bsz, h // f, w // f, 1), dtype=jnp.float32))
                       for k, f in zip(keys, (2, 4))]
    if d == "GMD":
        out["gmd"] = nchw(jax.random.uniform(k_gmd, (bsz, h // 8 - 2, w // 8 - 2, 1), dtype=jnp.float32))
    if d == "Oreo":
        m = cfg.dropout["oreo_num_mask"]
        mask = jax.random.bernoulli(k_oreo, 1.0 - cfg.dropout["oreo_prob"],
                                    (m * bsz, cfg.dropout["num_embeddings"]))
        out["oreo"] = torch.from_numpy(np.asarray(mask, np.float32))
    return out


def assert_grads_close(port_grads: dict, jax_grads, pcfg, frac: float, keys=None):
    """Every leaf of the port's gradients (or those named in ``keys``)
    within ``frac`` of the JAX leaf's largest magnitude (JAX's tree
    converted with params_from_flax, which is linear)."""
    want = convert.params_from_flax(jax.tree.map(np.asarray, jax_grads), pcfg)
    if keys is not None:
        want = {k: want[k] for k in keys}
    assert set(want) == set(port_grads), set(want) ^ set(port_grads)
    for k, w in want.items():
        g = port_grads[k].detach().float().cpu()
        bar = frac * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= bar, (k, err, bar)


KEY = jax.random.PRNGKey(1)  # the train step's key in every JAX-side BC run
REG_METHODS = ("Teacher", "Reg", "Contrastive", "GRIL")  # the methods with a regularizer


def he_params(models, jcfg, seed=0):
    """Flax parameters of init_bc_params' shapes, He-normal from numpy
    (biases zero): at full width, flax's orthogonal init of the pre-actor
    costs the CPU half a minute."""
    shapes = jax.eval_shape(lambda: JB.init_bc_params(models, jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "bias":
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(rng.standard_normal(s.shape, np.float32) * np.sqrt(2.0 / np.prod(s.shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_loss(jcfg, batch, seed=0, train=True, jit=False):
    """(flax params, loss, metrics, grads) of jax.value_and_grad(bc_loss_fn)
    with key KEY; ``jit`` also takes he_params for speed at full width."""
    models = JB.build_bc_models(jcfg)
    params = he_params(models, jcfg, seed) if jit else JB.init_bc_params(models, jcfg, jax.random.PRNGKey(seed))
    jb = jax.tree.map(jnp.asarray, batch)
    fn = jax.value_and_grad(lambda p: JB.bc_loss_fn(p, models, jcfg, jb, KEY, train=train), has_aux=True)
    (loss, m), grads = (jax.jit(fn) if jit else fn)(params)
    return params, float(loss), {k: float(v) for k, v in m.items()}, grads


def port_loss(pcfg, flax_params, batch, draws, per_key=None, train=True):
    """(loss, metrics, grads) of the port's bc_loss_fn on the CPU, with the
    flax params converted."""
    models = PB.build_bc_models(pcfg, device="cpu")
    params = convert.params_from_flax(jax.tree.map(np.asarray, flax_params), pcfg)
    loss, m, grads = PB.loss_and_grads(models, pcfg, params, torch_batch(batch), draws, train=train,
                                       per_key=per_key)
    return float(loss), {k: float(v) for k, v in m.items()}, grads


def check_against_jax(jcfg, pcfg, batch=None, per_key=None, train=True):
    """The port's loss, metrics (rtol 1e-5) and gradients (1e-4 of each
    leaf's scale) against JAX's on ``batch``, with JAX's draws replayed;
    returns JAX's metrics."""
    batch = bc_batch() if batch is None else batch
    params, loss, metrics, grads = jax_loss(jcfg, batch, train=train)
    draws = jax_bc_draws(jcfg, KEY, batch["obs_seq"].shape[0])
    p_loss, p_metrics, p_grads = port_loss(pcfg, params, batch, draws, per_key, train)
    np.testing.assert_allclose(p_loss, loss, rtol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(p_metrics[k], metrics[k], rtol=1e-5, err_msg=k)
    assert_grads_close(p_grads, grads, pcfg, 1e-4)
    return metrics


def check_method(gaze: str, dropout: str):
    """One gaze x dropout method against JAX. Oreo with a regularizer runs
    at oreo_num_mask 1: at 2 the JAX package fails on a shape mismatch (the
    port tiles the regularizer's targets, train/bc.py)."""
    over = {"dropout.oreo_num_mask": 1} if dropout == "Oreo" and gaze in REG_METHODS else {}
    metrics = check_against_jax(*bc_cfgs(gaze, dropout, **over))
    assert (metrics["loss_reg"] > 0) == (gaze in REG_METHODS)
