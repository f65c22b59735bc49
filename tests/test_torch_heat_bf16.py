"""Port parity in bf16 at the anchor's size: ViSaRL and its controls.

The round-5 anchor trains and evaluates every method in bf16, the default
``training.compute_dtype``. tests/test_torch_heat_full_size.py holds the
heat-input methods at 180x320 in float32; this file holds them where the
anchor runs them: default_bc_config() (180x320 grayscale, frame stack 2,
hiddens 128, z_dim 256) in bf16, against the JAX package on the CPU, on the
same numpy parameters and batch. ViSaRL is the method under test (the heat
as raw extra channels of the encoder: JAX train/bc.py:266 and :353);
None, Mask and AGIL are the controls, held to the same bar:

- the eval policy on the training batch's human-gaze heat, with the
  encoder's input dtype;
- the train step's loss and every gradient leaf (jax.value_and_grad of
  bc_loss_fn);
- the eval heat: the frozen UNet predictor in bf16 through the port's
  rollout (eval/rollout.py ``compute_heat``: clamp, then repeat over the
  frame stack) against JAX's clip and repeat (JAX eval/rollout.py:95-97) on
  the same frames, and the ViSaRL policy on each package's heat.

The bar. bf16 keeps 8 significant bits, so its unit roundoff is
u = 2^-8. XLA and torch round at different places (XLA keeps a fused
chain's intermediates in float32, torch's thread count moves its sums), so
the two packages' bf16 results differ by a few u where their float32
results differ by 1e-6. Each gap is a relative L2 norm, |port - JAX| /
|JAX|, and every method is held to the same bar: ``FORWARD_BAR`` = 8u for
forward values, which cross up to 27 bf16 layers (the UNet's 18 convs,
then the encoder's 9), and ``GRAD_BAR`` = 32u for gradients, whose
cotangents cross them again backwards. Measured here: actions 1.2-2.2u,
losses 0.4-1.2u, the heat 3.3-3.9u and the actions on it 3.5-4.2u (one
torch thread or eight), all gradients 3.6-17.6u, the first conv's
7.5-15.7u. A ViSaRL-specific fault would put ViSaRL off by clearly more
than the controls: test_visarl_gap_is_the_controls holds each of its gaps
within twice the controls' largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.models.unet import UNet as JUNet
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.eval import rollout as PRO
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.train.gaze_predictor import build_gaze_models, make_gaze_predictor_apply
from gabril_carla_tpu_torch.utils.config import default_gaze_config
from gabril_carla_tpu_torch.utils.prng import prng_key, split
from test_torch_common import KEY, bc_batch, cpu_threads, he_params, jax_bc_draws, port_loss
from test_torch_heat_full_size import full_size_cfgs
from test_torch_rollout_heat import spec_straight

U = 2.0 ** -8  # bf16's unit roundoff
FORWARD_BAR, GRAD_BAR = 8 * U, 32 * U
CONTROLS = ("None", "Mask", "AGIL")
METHODS = CONTROLS + ("ViSaRL",)
B = 2
POLICY_SEEDS = (3, 4, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def batch():
    return bc_batch(B, seed=7, hw=(180, 320), max_points=5)


def encoder_input_dtypes(models) -> list:
    """The dtypes the port's encoder is called with, appended as it runs."""
    seen = []
    models.encoder.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    return seen


@functools.lru_cache(maxsize=None)
def policy_gap(gaze: str) -> dict:
    """The eval policy of both packages on the training batch's heat, for
    the parameter draws ``POLICY_SEEDS`` (one compile), as one gap."""
    jcfg, pcfg = full_size_cfgs(gaze, "bfloat16")
    models = JB.build_bc_models(jcfg)
    xx, heat, _ = models.heatmapper.prepare_for_bc(jnp.asarray(batch()["obs_seq"]),
                                                   jnp.asarray(batch()["gaze_seq"]),
                                                   jcfg.data["frame_stack"], grayscale=True)
    jpolicy = jax.jit(JB.make_bc_policy_fn(models, jcfg))
    pmodels = PB.build_bc_models(pcfg, device="cpu")
    seen = encoder_input_dtypes(pmodels)
    policy = PB.make_bc_policy_fn(pmodels, pcfg)
    want, got = [], []
    for seed in POLICY_SEEDS:
        params = he_params(models, jcfg, seed=seed)
        want.append(np.asarray(jpolicy(params, xx, heat)))
        state = convert.params_from_flax(jax.tree.map(np.asarray, params), pcfg)
        with torch.inference_mode():
            got.append(policy(state, torch.from_numpy(np.array(xx)), torch.from_numpy(np.array(heat))))
    # JAX's encoder input: jnp.concatenate / multiply of obs and heat
    # (bc.py:351-353), whose dtype is their promotion
    jax_in = jnp.result_type(xx, heat) if gaze in ("Mask", "ViSaRL") else xx.dtype
    return dict(gap=rel(np.stack([g.numpy() for g in got]), np.stack(want)), dtype=got[0].dtype,
                shape=tuple(got[0].shape), want_shape=want[0].shape, enc_in=set(seen),
                jax_enc_in=str(jax_in))


@functools.lru_cache(maxsize=None)
def step_gap(gaze: str) -> dict:
    """The train step's loss and gradients of both packages, JAX's draws
    replayed (none without dropout)."""
    jcfg, pcfg = full_size_cfgs(gaze, "bfloat16")
    models = JB.build_bc_models(jcfg)
    params = he_params(models, jcfg, seed=0)
    fn = jax.value_and_grad(lambda p: JB.bc_loss_fn(p, models, jcfg, jax.tree.map(jnp.asarray, batch()),
                                                    KEY, train=True), has_aux=True)
    (loss, _), grads = jax.jit(fn)(params)
    p_loss, _, p_grads = port_loss(pcfg, params, batch(), jax_bc_draws(jcfg, KEY, B))
    want = convert.params_from_flax(jax.tree.map(np.asarray, grads), pcfg)
    assert set(want) == set(p_grads)
    first = "encoder.down1.weight"
    flat = lambda tree: np.concatenate([tree[k].float().numpy().ravel() for k in sorted(want)])
    return dict(loss=abs(p_loss - float(loss)) / abs(float(loss)), grads=rel(flat(p_grads), flat(want)),
                first_conv=rel(p_grads[first].float().numpy(), want[first].numpy()))


@pytest.mark.parametrize("gaze", METHODS)
def test_policy_matches_jax_in_bf16(gaze):
    g = policy_gap(gaze)
    assert g["dtype"] == torch.float32 and g["shape"] == g["want_shape"] == (B, 7)
    assert g["gap"] <= FORWARD_BAR, g["gap"]
    # both sides promote: float32 frames with float32 (training) heat
    assert {str(d).replace("torch.", "") for d in g["enc_in"]} == {g["jax_enc_in"]} == {"float32"}


@pytest.mark.parametrize("gaze", METHODS)
def test_train_step_matches_jax_in_bf16(gaze):
    g = step_gap(gaze)
    assert g["loss"] <= FORWARD_BAR, g["loss"]
    assert g["grads"] <= GRAD_BAR and g["first_conv"] <= GRAD_BAR, g


def test_visarl_gap_is_the_controls():
    """ViSaRL's gaps (actions, loss, the first conv's gradient: its one
    layer with 2S input channels) within twice the largest of the controls'."""
    for name, gap in (("policy", lambda m: policy_gap(m)["gap"]), ("loss", lambda m: step_gap(m)["loss"]),
                      ("first conv", lambda m: step_gap(m)["first_conv"])):
        controls = max(gap(m) for m in CONTROLS)
        assert gap("ViSaRL") <= 2 * controls, (name, gap("ViSaRL"), controls)


def unet_params(jm, seed=0):
    """Flax UNet parameters from numpy: He-normal kernels, zero biases,
    GroupNorm scales 1 + N(0, 0.1) (flax's init costs the CPU most of a
    minute at 180x320)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 180, 320, 2))))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape, np.float32) * np.float32(np.sqrt(2.0 / np.prod(s.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def eval_heat_gaps() -> dict:
    """The UNet's heat in bf16 through the port's rollout (two ticks on a
    straight road, a probe policy recording what the ViSaRL policy gets)
    against JAX's clip and repeat on the same frames, and the ViSaRL
    actions on each package's heat."""
    jcfg, pcfg = full_size_cfgs("ViSaRL", "bfloat16")
    jm = JUNet(output_channels=1, dtype=jnp.bfloat16)
    gparams = unet_params(jm)
    gcfg = default_gaze_config()
    gcfg["model"]["arch"] = "unet"
    assert gcfg.training["compute_dtype"] == "bfloat16"
    gmodel, _ = build_gaze_models(gcfg, device="cpu")
    models = JB.build_bc_models(jcfg)
    params = he_params(models, jcfg, seed=5)
    pmodels = PB.build_bc_models(pcfg, device="cpu")
    seen = encoder_input_dtypes(pmodels)
    policy = PB.make_bc_policy_fn(pmodels, pcfg)
    state = convert.params_from_flax(jax.tree.map(np.asarray, params), pcfg)
    state["gaze_predictor"] = convert.gaze_params_from_flax(gparams, gcfg)
    calls = []

    def probe(p, obs, heat=None):
        calls.append((obs, heat, policy(p, obs, heat)))
        return calls[-1][2]

    roll = PRO.make_rollout_fn(probe, pcfg, steps=2, gaze_predictor_apply=make_gaze_predictor_apply(gmodel))
    roll(spec_straight(), state, split(prng_key(0), 1))
    obs, heat, act = calls[-1]
    jheat_fn = jax.jit(lambda p, o: jnp.repeat(jnp.clip(jm.apply({"params": p}, o), 0.0, 1.0), 2, axis=-1))
    want = jheat_fn(gparams, jnp.asarray(obs.numpy()))
    want_act = np.asarray(jax.jit(JB.make_bc_policy_fn(models, jcfg))(params, jnp.asarray(obs.numpy()), want))
    got = heat.float().numpy()
    return dict(calls=len(calls), enc_in=seen, dtype=str(heat.dtype).replace("torch.", ""),
                want_dtype=str(want.dtype), shape=tuple(heat.shape), want_shape=want.shape, heat=got,
                heat_gap=rel(got, np.asarray(want, np.float32)), act_gap=rel(act.numpy(), want_act),
                jax_enc_in=str(jnp.result_type(jnp.float32, want.dtype)))


def test_eval_heat_matches_jax_in_bf16():
    """The eval heat: the same dtype (bf16) and shape in both packages,
    values in [0, 1] within FORWARD_BAR of JAX's; the ViSaRL encoder fed
    float32 (frames and bf16 heat promoted, as jnp.concatenate does) and
    its actions within FORWARD_BAR."""
    g = eval_heat_gaps()
    assert g["calls"] == 2 and g["enc_in"] == [torch.float32] * 2 and g["jax_enc_in"] == "float32"
    assert g["dtype"] == g["want_dtype"] == "bfloat16"
    assert g["shape"] == g["want_shape"] == (1, 180, 320, 2)
    heat = g["heat"]
    assert heat.min() >= 0.0 and heat.max() <= 1.0 and 0.05 < float((heat > 0).mean()) < 0.95
    assert g["heat_gap"] <= FORWARD_BAR and g["act_gap"] <= FORWARD_BAR, g


if __name__ == "__main__":
    # the gaps in units of u, on THREADS torch threads (1):
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_heat_bf16.py [THREADS]
    import sys

    torch.set_num_threads(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
    print("| Method | actions (3 weight draws) | loss | all gradients | first conv's gradient |")
    print("| --- | --- | --- | --- | --- |")
    for m in METHODS:
        p, g = policy_gap(m), step_gap(m)
        print(f"| {m} | {p['gap'] / U:.2f}u | {g['loss'] / U:.2f}u | {g['grads'] / U:.1f}u | "
              f"{g['first_conv'] / U:.1f}u |")
    h = eval_heat_gaps()
    print(f"eval heat {h['heat_gap'] / U:.2f}u, ViSaRL actions on it {h['act_gap'] / U:.2f}u")
