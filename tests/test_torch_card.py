"""Card tests of the port (marker ``gpu``): the render kernel, BC training,
the gaze-heat eval path and the offline data-to-policy path on the card.

They need a CUDA card and skip without one; the CPU parity tests in
tests/test_torch_render.py and tests/test_torch_train*.py hold the CPU path
to the JAX package. This file imports neither JAX nor the JAX package, so it
runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_card.py -q

The scenes and the training checks are chip_smoke.py's (run from the repo
root, as above). Bars: chip_smoke.py's; for the kernel at most FLIP_PX
pixels a frame off by more than 1e-5, as kernel and plain version visit the
same rows and boxes; for training, every gaze x dropout method's metrics
within LOSS_RTOL and gradients within GRAD_FRAC of their leaf's scale of the
same code on the CPU; for the gaze predictor the same bars on its float32
forward and loss and on its gradients (chip_smoke.gaze_agrees), and
analytic gaze within 1e-4 of the CPU apart from slots whose hazard scores
tie; each heat rollout launches the kernel ticks + 1 times; the expert
within chip_smoke.EXPERT_TOL of the CPU with equal brakes, the VQ-VAE as
chip_smoke.vqvae_agrees says, and a resumed Oreo run bitwise equal to the
whole one (chip_smoke.run_resume_check), collection launching the kernel
once a tick; at world size 1 on NCCL, the all-reduced step bitwise the
plain one and the sharded eval bitwise rollout_routes without a mesh; the
human loop's core launching the kernel once a tick and replayed bitwise
through collect; the native gather bitwise the numpy loop on the card
machine's host; the threefry kernel bitwise its plain version and numpy's
threefry, once a launch a draw of a train step.
"""

import itertools

import pytest
import torch

from chip_smoke import (EXPERT_TOL, FLIP_PX, GRAD_FRAC, LOSS_RTOL, _crossing_scene, _crowded,
                        _mid_route, _tight_loop, analytic_card_vs_cpu, bench_batch, bench_train_cfg,
                        card_vs_cpu, expert_card_vs_cpu, gaze_agrees, gaze_card_vs_cpu, heat_cases,
                        off_pixels, operands, run_resume_check, single_route, vqvae_agrees,
                        vqvae_card_vs_cpu)
from gabril_carla_tpu_torch.data.tasks import seen_routes
from gabril_carla_tpu_torch.env.env import DrivingEnv
from gabril_carla_tpu_torch.env.criteria import compute_score
from gabril_carla_tpu_torch.env.world import load_benchmark_specs, to_torch
from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn
from gabril_carla_tpu_torch.ops import raster as R
from gabril_carla_tpu_torch.ops import render_kernel as K
from gabril_carla_tpu_torch.train.bc import (DROPOUT_METHODS, GAZE_METHODS, init_bc_state,
                                             make_bc_policy_fn, make_bc_train_step)
from gabril_carla_tpu_torch.train.optim import build_optimizer
from gabril_carla_tpu_torch.utils.prng import prng_key, split

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the render kernel has no CPU mode")
    return torch.device("cuda")


def _real_routes(device):
    spec = to_torch(load_benchmark_specs(seen_routes()[:3]), device)
    return spec, DrivingEnv().reset(spec)


def _scene(builder):
    """A chip_smoke.py scene builder as device -> (spec, state)."""
    return lambda device: single_route(*builder(), device)


# name -> (scene, the branch its camera slots must show)
SCENES = {"real_routes": (_real_routes, lambda cam: cam[:, 14] >= 0),
          "tight_loop": (_scene(_tight_loop), lambda cam: cam[:, 11] > 56),
          "mid_route": (_scene(_mid_route), lambda cam: (cam[:, 16] >= 12) & (cam[:, 17] >= 44)),
          "crowded": (_scene(_crowded), lambda cam: cam[:, 15] > 24)}
FLAGS = list(itertools.product((False, True), repeat=2))  # (far_decimate, lower_window)


def _assert_frames_match(a, b):
    off, mx = off_pixels(a, b)
    assert int(off.max()) <= FLIP_PX, (off.tolist(), mx)


def test_kernel_matches_plain_on_real_routes(cuda):
    ops = operands(*_real_routes(cuda))
    before = K.render_kernel.launches
    out = K.render_from_operands(*ops)
    torch.cuda.synchronize()
    assert K.render_kernel.launches == before + 1
    assert out.shape == (3, 180, 320) and out.dtype == torch.float32
    _assert_frames_match(out, K.render_from_operands_plain(*ops))


def test_kernel_matches_plain_with_crossing_flow(cuda):
    ops = operands(*_scene(_crossing_scene)(cuda))
    _assert_frames_match(K.render_from_operands(*ops), K.render_from_operands_plain(*ops))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: f"fd{int(f[0])}-lw{int(f[1])}")
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_matches_plain_with_flags(cuda, name, flags):
    far_decimate, lower_window = flags
    scene, branch = SCENES[name]
    ops = operands(*scene(cuda), far_decimate=far_decimate)
    assert branch(ops[0]).all(), ops[0][:, 11:18]
    before = K.render_kernel.launches
    out = K.render_from_operands(*ops, far_decimate=far_decimate, lower_window=lower_window)
    torch.cuda.synchronize()
    assert K.render_kernel.launches == before + 1
    plain = K.render_from_operands_plain(*ops, far_decimate=far_decimate, lower_window=lower_window)
    print(f"{name} {flags}: max abs error {(out - plain).abs().max().item():.3g}")
    _assert_frames_match(out, plain)


def test_render_frame_launches_once_per_call(cuda):
    spec = to_torch(load_benchmark_specs(seen_routes()[:1]), cuda)
    state = DrivingEnv().reset(spec)
    before = K.render_kernel.launches
    R.render_frame(spec, state)
    R.render_frame(spec, state, far_decimate=True, lower_window=True)
    assert K.render_kernel.launches == before + 2


def test_wrapper_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        K.render_from_operands(torch.zeros(1, 18, device=cuda), torch.zeros(1, 160, 8),
                               torch.zeros(1, 32, 8, device=cuda))


def test_wrapper_rejects_misaligned_operands(cuda):
    rows = torch.zeros(160 * 8 + 1, device=cuda)[1:].view(1, 160, 8)  # contiguous, 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        K.render_from_operands(torch.zeros(1, 18, device=cuda), rows,
                               torch.zeros(1, 32, 8, device=cuda))


@pytest.mark.parametrize("dropout", DROPOUT_METHODS)
@pytest.mark.parametrize("gaze", GAZE_METHODS)
def test_train_method_matches_cpu(cuda, gaze, dropout):
    loss_gap, grad_gap = card_vs_cpu(gaze, dropout)
    assert loss_gap <= LOSS_RTOL and grad_gap <= GRAD_FRAC, (loss_gap, grad_gap)


def test_bench_config_train_steps(cuda):
    """Two steps at bench_train.py's configuration (batch 2000, Reg, bf16):
    finite, loss_reg > 0, and every parameter moved by the second (the
    warmup schedule's rate is 0 at the first)."""
    cfg = bench_train_cfg()
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
    models, state0 = init_bc_state(cfg, prng_key(0), tx)
    step = make_bc_train_step(models, cfg)
    batch = bench_batch(cfg, cfg.data["batch_size"], cuda)
    keys = split(prng_key(1))
    state, _ = step(state0, batch, keys[0])
    state, metrics = step(state, batch, keys[1])
    assert all(bool(torch.isfinite(v)) for v in metrics.values()) and float(metrics["loss_reg"]) > 0
    moved = [k for k in state.params if not torch.equal(state.params[k], state0.params[k])]
    assert len(moved) == len(state.params), set(state.params) - set(moved)


@pytest.mark.parametrize("arch", ["autoencoder", "unet"])
def test_gaze_predictor_matches_cpu(cuda, arch):
    gaps = gaze_card_vs_cpu(arch)
    assert gaze_agrees(arch, gaps), gaps


@pytest.mark.parametrize("case", ["mask_predictor", "gmd_analytic", "confounded"])
def test_heat_rollout_launches_and_kernel(cuda, case):
    """A 12-tick heat rollout of three real routes at full width: the kernel
    launches ticks + 1 times, the heat stays in [0, 1], the scores are
    finite, and at the final state the kernel matches its plain version."""
    cfg, models, params, kw = heat_cases(cuda)[case]
    policy = make_bc_policy_fn(models, cfg)
    seen = []

    def probe(p, obs, heat=None):
        if heat is not None:
            seen.append((float(heat.amin()), float(heat.amax())))
        return policy(p, obs, heat)

    spec = to_torch(load_benchmark_specs(seen_routes()[:3]), cuda)
    before = K.render_kernel.launches
    state, _ = make_rollout_fn(probe, cfg, steps=12, **kw)(spec, params, split(prng_key(0), 3))
    torch.cuda.synchronize()
    assert K.render_kernel.launches == before + 13
    assert all(0.0 <= lo and hi <= 1.0 for lo, hi in seen) and (case == "confounded") == (not seen)
    assert bool(torch.isfinite(compute_score(spec, state)["score_composed"]).all())
    ops = operands(spec, state)
    _assert_frames_match(K.render_from_operands(*ops), K.render_from_operands_plain(*ops))


@pytest.mark.parametrize("curv", [False, True])
def test_analytic_gaze_matches_cpu(cuda, curv):
    spec, state = _real_routes(cuda)
    cfg, models, params, _ = heat_cases(cuda)["confounded"]
    state, _ = make_rollout_fn(make_bc_policy_fn(models, cfg), cfg, steps=20)(
        spec, params, split(prng_key(1), spec.route_len.shape[0]))
    bad, tied, mx = analytic_card_vs_cpu(spec, state, curv)
    assert bad == 0, (bad, tied, mx)


def test_expert_matches_cpu(cuda):
    """A 120-tick expert rollout of three real routes on the card; at every
    40th tick the expert on the card against the CPU on the same state."""
    from gabril_carla_tpu_torch.cli.collect import seed_draws
    from gabril_carla_tpu_torch.env.expert import expert_action

    spec, state = _real_routes(cuda)
    draws = seed_draws([0, 1, 2], 120, cuda)
    states = []
    for t in range(120):
        if t % 40 == 0:
            states.append(state)
        state = DrivingEnv().step(spec, state, expert_action(spec, state), draws[t])
    flips, gap = expert_card_vs_cpu(spec, states + [state])
    assert flips == 0 and gap <= EXPERT_TOL, (flips, gap)
    assert float((state.ego.pos - spec.spawn_pos).norm(dim=-1).min()) > 5.0


def test_vqvae_matches_cpu(cuda):
    gaps = vqvae_card_vs_cpu()
    assert vqvae_agrees(gaps), gaps


def test_collect_and_resume_on_card(cuda, tmp_path):
    """collect.main (3 seeds, 40 ticks: one launch a tick), a 1-epoch
    VQ-VAE on the episodes, and the resume check on them."""
    from unittest import mock

    from chip_smoke import PIPE_COMMON, episode_dataset
    from gabril_carla_tpu_torch.cli import collect, train_bc, train_vqvae

    before = K.render_kernel.launches
    collect.main(["--route", "3100", "--steps", "40", "--seeds", "1", "2", "3", "--out", str(tmp_path / "eps")])
    torch.cuda.synchronize()
    assert K.render_kernel.launches == before + 40
    with mock.patch.object(train_bc, "build_dataset", episode_dataset(tmp_path / "eps")):
        train_vqvae.main(PIPE_COMMON + ["training.epochs=1", "data.task=Vq",
                                        f"logging.log_dir={tmp_path / 'runs'}"])
    vq = next((tmp_path / "runs").glob("Vq/*/checkpoints")) / "ep1"
    res = run_resume_check(tmp_path / "eps", vq, tmp_path / "resume")
    assert not res["params"] and not res["opt_state"] and res["step"][0] == res["step"][1], res


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL group (the card's machine has one card) and its
    ('data', 'model') mesh."""
    from chip_smoke import one_rank_group
    from gabril_carla_tpu_torch.parallel import make_mesh

    with one_rank_group("nccl"):
        yield make_mesh(device="cuda")


def test_allreduce_step_bitwise_at_world_size_1(nccl_mesh):
    """The BC step with the mesh's all-reduce equals the step without a
    group, bitwise (chip_smoke.allreduce_step_check, batch 8)."""
    from chip_smoke import allreduce_step_check

    assert allreduce_step_check(nccl_mesh, batch_size=8)["bitwise"]


def test_sharded_eval_equals_unsharded(nccl_mesh):
    """rollout_routes with the mesh equals it without, bitwise, on 3 real
    routes x 12 ticks; K1 launches ticks + 1 times and matches its plain
    version (chip_smoke.sharded_eval_check)."""
    from chip_smoke import THROTTLE_BIAS, sharded_eval_check
    from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params
    from gabril_carla_tpu_torch.utils.config import default_bc_config

    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = "float32"
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    models = build_bc_models(cfg, "cuda")
    params = init_bc_params(models, cfg, prng_key(0))
    params["actor.fc2.bias"][0] = THROTTLE_BIAS
    out = sharded_eval_check(nccl_mesh, make_bc_policy_fn(models, cfg), cfg, params,
                             load_benchmark_specs(seen_routes()[:3]), 12)
    assert out["bitwise"] and out["launches"] == 13


def test_human_core_replays_through_collect_on_card(cuda, tmp_path):
    """HumanLoop's core on the card (route 3100, seed 200, 40 scripted
    ticks): K1 once a tick; collect replaying the recorded actions with the
    seed's draws gives the frames bitwise and the same stats.json record
    (chip_smoke.human_drive, human_replay)."""
    from chip_smoke import HUMAN_KEYS, human_drive, human_replay

    loop, launches, _, _ = human_drive(cuda, tmp_path, HUMAN_KEYS[:40])
    assert launches == 40
    same_frames, same_record, rec = human_replay(loop, loop.save())
    assert same_frames and same_record, rec


def test_native_gather_on_the_card_host(cuda):
    """On the card machine's host: the native gather bitwise the numpy
    loop at the episode edges and on random batches of 500 at 180x320x3
    (chip_smoke.gathers_agree), and a gathered batch copied to the card
    unchanged."""
    import numpy as np

    from chip_smoke import gathers_agree
    from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes

    store = synthetic_episodes(n_demos=4, steps=150, seed=1).finalize()
    same, _, _ = gathers_agree(store, 500, 2)
    assert same
    batch = BCDataset(store, 2).sample(np.arange(500))
    for v in batch.values():
        assert torch.equal(torch.from_numpy(v).to(cuda).cpu(), torch.from_numpy(v))


# --- JAX's training draws on the card (csrc/threefry.cu) ----------------------


@pytest.mark.parametrize("n,offset,p", [(1, 0, None), (28_800_000, 0, None), (4096, 2**32 - 2048, None),
                                        (1_024_000, 7, 0.5)], ids=["one", "igmd", "high_word", "oreo"])
def test_threefry_kernel_matches_plain(cuda, n, offset, p):
    """The kernel bitwise its plain version on the card, one launch a call;
    the first 4096 elements bitwise numpy's threefry (chip_smoke.host_uniform)."""
    from chip_smoke import host_uniform
    from gabril_carla_tpu_torch.ops import threefry_kernel as TK

    key = split(prng_key(3))[1]
    before = TK.threefry_kernel.launches
    got = TK.random_floats(key, n, cuda, offset, p)
    torch.cuda.synchronize()
    assert TK.threefry_kernel.launches == before + 1 and got.shape == (n,) and got.dtype == torch.float32
    plain = TK.random_floats_plain(key, n, cuda, offset, p)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    m = min(n, 4096)
    want = host_uniform(key, offset, m)
    if p is not None:
        want = (want < 0.5).astype("float32")
    assert (got[:m].cpu().numpy() == want).all()


@pytest.mark.parametrize("dropout,launches", [("None", 0), ("GMD", 1), ("IGMD", 2), ("Oreo", 1)])
def test_train_step_draws_on_card(cuda, dropout, launches):
    """A BC step's draws launch the kernel once a draw and equal the CPU's
    draws of the same key bitwise."""
    from chip_smoke import narrow_cfg
    from gabril_carla_tpu_torch.ops import threefry_kernel as TK
    from gabril_carla_tpu_torch.train.bc import step_draws

    cfg = narrow_cfg("Reg", dropout)
    before = TK.threefry_kernel.launches
    got = step_draws(prng_key(5), cfg, 4, cuda)
    assert TK.threefry_kernel.launches == before + launches
    want = step_draws(prng_key(5), cfg, 4, "cpu")
    for k in want:
        pairs = zip(got[k], want[k]) if k == "igmd" else [(got[k], want[k])]
        assert all(torch.equal(a.cpu(), b) for a, b in pairs)
