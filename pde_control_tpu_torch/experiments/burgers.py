"""Burgers experiments — BASELINE configs 1-2.

Counterpart of `pde_control_tpu/experiments/burgers.py`.
Config 1: CFE-chain supervised, N=32 grid, 32-step rollout.
Config 2: hierarchical OP refinement + end-to-end finetune.

Physical setup: unit domain, N=32 (dx=1/32), dt=0.03, ν=0.01 — explicit
diffusion stable (ν·dt/dx² ≈ 0.31 < 0.5). The same seeds and force
amplitude as the JAX package. Every entry takes `device` (the card unless
given); on the card the fp32 nets run their convs in full fp32
(`control/pde_burgers.py`).
"""

from __future__ import annotations

import os

from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
from pde_control_tpu_torch.control.training import ControlTraining
from pde_control_tpu_torch.data.generate import generate_burgers_dataset
from pde_control_tpu_torch.experiments.curriculum import (
    CurriculumConfig,
    evaluate_control,
    run_curriculum,
)
from pde_control_tpu_torch.physics.burgers import BurgersConfig

BURGERS_CFG = BurgersConfig(n=32, dx=1.0 / 32, dt=0.03, viscosity=0.01)


def make_datasets(n_steps: int, num_train: int, num_val: int, datadir: str,
                  device=None):
    os.makedirs(datadir, exist_ok=True)
    train = generate_burgers_dataset(BURGERS_CFG, num_train, n_steps, seed=0,
                                     force_amplitude=0.5, device=device)
    val = generate_burgers_dataset(BURGERS_CFG, num_val, n_steps, seed=999,
                                   force_amplitude=0.5, device=device)
    return train, val


def run_chain_supervised(workdir: str, n: int = 32, iterations: int = 2000,
                         num_train: int = 1024, num_val: int = 128,
                         batch_size: int = 32, device=None) -> dict:
    """Config 1: CFE chain supervised against ground-truth next frames.
    Eight steps run as one `progress_multi` call (CUDA graph replays on
    the card), as the curriculum's stages do; the JAX package runs one
    jitted step a call."""
    train, val = make_datasets(n, num_train, num_val, workdir, device=device)
    pde = BurgersPDE(BURGERS_CFG, device=device)
    app = ControlTraining(
        n, pde, dataset=train, val_dataset=val, batch_size=batch_size,
        trainable_networks=("CFE",), sequence_class="chain",
        obs_loss_frames=tuple(range(1, n + 1)), force_reg=1e-4,
        learning_rate=1e-3, logdir=os.path.join(workdir, "logs"),
    ).prepare()
    last = app.train(iterations, log_every=100, steps_per_call=8)
    app.save(os.path.join(workdir, "ckpt_cfe"))
    app.close()
    return {"train": last, "eval": evaluate_control(app, val, n)}


def run_hierarchical(workdir: str, n: int = 32, iterations: int = 1000,
                     num_train: int = 1024, num_val: int = 128,
                     batch_size: int = 32, device=None) -> dict:
    """Config 2: OP hierarchy supervised per level + staggered e2e finetune."""
    train, val = make_datasets(n, num_train, num_val, workdir, device=device)
    pde = BurgersPDE(BURGERS_CFG, device=device)
    cfg = CurriculumConfig(
        n=n, batch_size=batch_size,
        cfe_iterations=iterations, op_iterations=iterations,
        e2e_iterations=iterations, force_reg=1e-4,
    )
    return run_curriculum(pde, cfg, train, val, workdir)
