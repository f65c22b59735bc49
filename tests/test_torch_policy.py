"""Port parity: the BC policy (models/encoder.py, models/heads.py,
train/bc.py, convert.py).

Converted flax parameters give the actions of gabril_carla_tpu's
make_bc_policy_fn on the same frames: float32 within atol 1e-4 (both run
f32 convolutions on the CPU; only the summation order differs), bf16 within
the bound stated in test_bf16_policy_matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.models.heads import MLP as FlaxMLP
from gabril_carla_tpu.utils import default_bc_config
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.models.heads import MLP
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default_bc_config


def cfg_for(width: str, dtype: str, port: bool = False):
    cfg = (port_default_bc_config if port else default_bc_config)()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = dtype
    if width == "small":
        cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    return cfg


def both_policies(width, dtype, seed=0):
    cfg = cfg_for(width, dtype)
    models = JB.build_bc_models(cfg)
    params = JB.init_bc_params(models, cfg, jax.random.PRNGKey(seed))
    pcfg = cfg_for(width, dtype, port=True)
    pmodels = PB.build_bc_models(pcfg, device="cpu")
    state = convert.params_from_flax(jax.tree.map(np.asarray, params), pcfg)
    pmodels.load_state_dict(state)  # the names and shapes line up exactly
    jax_pol = jax.jit(JB.make_bc_policy_fn(models, cfg))
    return (lambda obs: np.asarray(jax_pol(params, jnp.asarray(obs))),
            lambda obs: PB.make_bc_policy_fn(pmodels, pcfg)(state, torch.from_numpy(obs)).numpy())


def frames(n=2, seed=0):
    return np.random.default_rng(seed).random((n, 180, 320, 2), dtype=np.float32)


@pytest.mark.parametrize("width", ["small", "full"])
def test_f32_policy_matches(width):
    jax_pol, port_pol = both_policies(width, "float32")
    obs = frames()
    want, got = jax_pol(obs), port_pol(obs)
    assert got.dtype == np.float32 and got.shape == (2, 7)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_policy_matches():
    """bf16 keeps 8 significant bits, and flax and torch round at different
    points (flax adds the bias after rounding the conv to bf16, torch's CPU
    conv inside; the accumulation orders differ), so the bound is a bf16
    one: within 1% of the logits' scale, elementwise (measured 0.3%)."""
    jax_pol, port_pol = both_policies("full", "bfloat16")
    obs = frames()
    want, got = jax_pol(obs), port_pol(obs)
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=0.01 * scale, rtol=0)


def test_default_config_matches():
    assert port_default_bc_config() == default_bc_config()


def test_flatten_permutation():
    """A Dense over an NHWC flatten (flax PreActor) equals a Linear over the
    NCHW flatten with the converted kernel."""
    rng = np.random.default_rng(1)
    h, w = PB.LATENT_HW
    c = 5
    z = rng.standard_normal((3, h, w, c))
    kernel = rng.standard_normal((h * w * c, 4))
    want = z.reshape(3, -1) @ kernel
    got = np.transpose(z, (0, 3, 1, 2)).reshape(3, -1) @ convert.flatten_rows_nhwc_to_nchw(kernel, c)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_mlp_matches_flax():
    x = np.random.default_rng(2).standard_normal((4, 12)).astype(np.float32)
    fm = FlaxMLP(output_dim=3, hidden_dim=6, hidden_depth=2)
    p = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    mlp = MLP(12, 3, 6, 2)
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            layer.weight.copy_(torch.from_numpy(np.asarray(p[f"Dense_{i}"]["kernel"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(p[f"Dense_{i}"]["bias"])))
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply({"params": p}, jnp.asarray(x))), atol=1e-5)


def test_init_is_seeded_orthogonal():
    cfg = cfg_for("small", "float32", port=True)
    a = PB.init_bc_params(PB.build_bc_models(cfg, device="cpu"), cfg, torch.Generator().manual_seed(0))
    b = PB.init_bc_params(PB.build_bc_models(cfg, device="cpu"), cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["encoder.mid.weight"].reshape(a["encoder.mid.weight"].shape[0], -1)
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(w.shape[0]), atol=1e-4)  # relu gain^2
    fc = a["actor.fc1.weight"]
    np.testing.assert_allclose((fc @ fc.T).numpy(), np.eye(fc.shape[0]), atol=1e-5)
    assert all(not v.any() for k, v in a.items() if k.endswith("bias"))


@pytest.mark.parametrize("gaze,dropout", [("Mask", "None"), ("Reg", "None"), ("None", "GMD")])
def test_unported_methods_raise(gaze, dropout):
    cfg = cfg_for("small", "float32", port=True)
    cfg["gaze"]["method"], cfg["dropout"]["method"] = gaze, dropout
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PB.build_bc_models(cfg, device="cpu")
