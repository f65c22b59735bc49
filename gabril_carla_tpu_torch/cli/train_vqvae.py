"""VQ-VAE pretraining CLI (port of gabril_carla_tpu/cli/train_vqvae.py): it
makes the checkpoint Oreo's dropout loads (``dropout.vqvae_path`` =
<run>/checkpoints/ep<N>).

    python -m gabril_carla_tpu_torch.cli.train_vqvae [--config YAML] key.sub=value ...
    torchrun --nproc_per_node N -m gabril_carla_tpu_torch.cli.train_vqvae ...  (data parallel)
"""

from __future__ import annotations

from ..train.loop import Trainer
from ..utils.config import default_bc_config
from . import train_bc


def main(argv=None, device="cuda"):
    cfg, _ = train_bc.parse(argv, default_bc_config().to_dict(), resume=False)
    trainer = Trainer(cfg, train_bc.build_dataset(cfg), mode="vqvae", device=device,
                      mesh=train_bc.launch_mesh(device))
    metrics = trainer.train()
    print("Training completed!", metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
