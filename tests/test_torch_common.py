"""Helpers shared by the port's parity tests (tests/test_torch_*.py): moving
specs and scene states from the JAX package to the port, replaying JAX's
per-step random draws, comparing state trees. It holds no tests.

Data crosses between the two frameworks as numpy arrays; JAX runs on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gabril_carla_tpu_torch.env import state as PS
from gabril_carla_tpu_torch.env.world import WorldSpec, to_torch

POOLS = {"ego": PS.EgoState, "vehicles": PS.ActorPool, "walkers": PS.WalkerPool,
         "statics": PS.StaticPool, "scenario": PS.ScenarioState, "criteria": PS.Criteria}


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
