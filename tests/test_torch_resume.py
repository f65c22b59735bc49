"""Full-state resume of the port's Trainer (train/loop.py: save_resume,
restore_resume, train(resume=True); train/checkpoint.py) and the CLI's
``--resume``: the port's forms of tests/test_resume.py's three tests, with
bit-for-bit continuation held in modes bc, gaze and vqvae, and of
tests/test_device_data.py's full-state checkpoint test.
"""

import json

import numpy as np
import pytest
import torch

from gabril_carla_tpu_torch.cli import train_bc
from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
from gabril_carla_tpu_torch.train.checkpoint import latest_resume_state, restore_params
from gabril_carla_tpu_torch.train.loop import Trainer
from gabril_carla_tpu_torch.utils.config import default_bc_config, default_gaze_config
from test_torch_common import cpu_threads

SMALL = {"img_hw": (24, 48), "max_points": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def cfg_for(mode, tmp_path, run_name, epochs, resume_interval=0, device_data=False):
    """tests/test_resume.py's configurations: BC Reg at 24x48; the gaze
    predictor and the VQ-VAE at 180x320 (the decoder's geometry) with tiny
    widths."""
    cfg = default_gaze_config() if mode == "gaze" else default_bc_config()
    if mode == "bc":
        cfg["data"].update(img_height=24, img_width=48, frame_stack=2, batch_size=8)
        cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                            num_residual_hiddens=8, z_dim=16)
        cfg["gaze"].update(method="Reg", max_points=3, mask_sigma=4.0)
    else:
        cfg["data"].update(img_height=180, img_width=320, frame_stack=2, batch_size=4)
        cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1,
                            num_residual_hiddens=4, z_dim=16)
        cfg["dropout"]["num_embeddings"] = 16
    cfg["training"].update(epochs=epochs, compute_dtype="float32", save_interval=99,
                           resume_interval=resume_interval, device_data=device_data)
    cfg["scheduler"]["type"] = "none"
    cfg["logging"]["log_dir"] = str(tmp_path)
    cfg["logging"]["run_name"] = run_name
    return cfg


def store_for(mode):
    if mode == "bc":
        return synthetic_episodes(n_demos=2, steps=20, **SMALL)
    return synthetic_episodes(n_demos=1, steps=10, img_hw=(180, 320), max_points=5)


def trainer(mode, cfg, store):
    return Trainer(cfg, BCDataset(store, frame_stack=2), mode=mode, device="cpu")


def assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("mode", ["bc", "gaze", "vqvae"])
def test_resume_reproduces_uninterrupted_run(tmp_path, mode):
    """Killed after 2 of 4 epochs (2 epochs with autosave) and resumed with
    the full budget: the final params equal the uninterrupted run's."""
    store = store_for(mode)
    full = trainer(mode, cfg_for(mode, tmp_path, "uninterrupted", 4), store)
    full.train()

    killed = trainer(mode, cfg_for(mode, tmp_path, "resumable", 2, resume_interval=1), store)
    killed.train()
    resumed = trainer(mode, cfg_for(mode, tmp_path, "resumable", 4, resume_interval=1), store)
    assert resumed.restore_resume() == 2
    assert_trees_equal(resumed.state.opt_state, killed.state.opt_state)
    resumed.train(resume=True)
    assert resumed.state.step == full.state.step
    assert_trees_equal(resumed.state.params, full.state.params)
    assert_trees_equal(resumed.state.opt_state, full.state.opt_state)
    # metrics.jsonl is one continuous curve: epochs 1..4 in order
    lines = [json.loads(x) for x in (tmp_path / cfg_for(mode, tmp_path, "r", 1)["data"]["task"]
                                     / "resumable" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [1.0, 2.0, 3.0, 4.0]


def test_incomplete_checkpoint_is_ignored(tmp_path):
    store = store_for("bc")
    tr = trainer("bc", cfg_for("bc", tmp_path, "killed", 2, resume_interval=1), store)
    tr.train()
    ckpt_dir = tr.logger.ckpt_dir
    assert sorted(p.name for p in ckpt_dir.glob("_resume_ep*")) == ["_resume_ep2"]  # older pruned
    # a mid-save kill leaves a tree without meta.json: skipped
    bogus = ckpt_dir / "_resume_ep9"
    bogus.mkdir()
    (bogus / "tree.pt").write_bytes(b"partial")
    path, meta = latest_resume_state(ckpt_dir)
    assert meta["epoch_done"] == 2 and path == ckpt_dir / "_resume_ep2" / "tree.pt"
    tr2 = trainer("bc", cfg_for("bc", tmp_path, "killed", 3, resume_interval=1), store)
    assert tr2.restore_resume() == 2


def test_gaze_keep_best_survives_resume(tmp_path):
    store = store_for("gaze")
    tr = trainer("gaze", cfg_for("gaze", tmp_path, "gazerun", 2, resume_interval=1), store)
    tr.train()
    assert tr._best_params is not None
    tr2 = trainer("gaze", cfg_for("gaze", tmp_path, "gazerun", 3, resume_interval=1), store)
    assert tr2.restore_resume() == 2
    assert tr2._best_epoch == tr._best_epoch and tr2._best_loss == tr._best_loss
    assert_trees_equal(tr2._best_params, tr._best_params)


@pytest.mark.parametrize("device_data", [False, True])
def test_full_state_checkpoint_resume(tmp_path, device_data):
    """save_resume / restore_resume round trip (tests/test_device_data.py:91)."""
    store = synthetic_episodes(n_demos=2, steps=16, **SMALL)
    cfg = cfg_for("bc", tmp_path, "fullstate", 2, device_data=device_data)
    tr = trainer("bc", cfg, store)
    tr.train()
    tr.save_resume(epoch_done=2)
    tr2 = trainer("bc", cfg_for("bc", tmp_path, "fullstate", 2, device_data=device_data), store)
    assert tr2.device_mode == device_data
    assert tr2.restore_resume() == 2
    assert tr2.state.step == tr.state.step and tr2._global_step == tr._global_step
    assert_trees_equal(tr2.state.params, tr.state.params)
    assert_trees_equal(tr2.state.opt_state, tr.state.opt_state)
    np.testing.assert_array_equal(tr2._step_key, tr._step_key)
    assert tr2._step_key.dtype == tr._step_key.dtype == np.uint32
    assert tr2._rng.bit_generator.state == tr._rng.bit_generator.state


def test_train_bc_cli_resume(tmp_path, capsys):
    """train_bc --resume RUN_DIR continues the run in place: a 1-epoch run
    resumed to 2 epochs equals a 2-epoch run."""
    args = ["data.img_height=24", "data.img_width=48", "data.batch_size=8", "model.embedding_dim=8",
            "model.num_hiddens=16", "model.num_residual_layers=1", "model.num_residual_hiddens=8",
            "model.z_dim=16", "gaze.method=Reg", "gaze.max_points=3", "gaze.mask_sigma=4.0",
            "training.compute_dtype=float32", "scheduler.type=none", "data.task=Cli",
            f"logging.log_dir={tmp_path}"]
    assert train_bc.main(args + ["training.epochs=2", "logging.run_name=full"], device="cpu") == 0
    assert train_bc.main(args + ["training.epochs=1", "logging.run_name=part",
                                 "training.resume_interval=1"], device="cpu") == 0
    run = tmp_path / "Cli" / "part"
    assert train_bc.main(["--resume", str(run), "training.epochs=2"] + args[:-2], device="cpu") == 0
    assert "resumed from epoch 1" in capsys.readouterr().out
    full = restore_params(tmp_path / "Cli" / "full" / "checkpoints" / "ep2")
    assert_trees_equal(restore_params(run / "checkpoints" / "ep2"), full)
    assert latest_resume_state(run / "checkpoints")[1]["epoch_done"] == 2
    with pytest.raises(SystemExit, match="no such run directory"):
        train_bc.main(["--resume", str(tmp_path / "absent")], device="cpu")
