"""Adam with a global-norm clip and a cosine schedule, as tensor code.

Computes what the JAX package's optimizer computes for the trainable
networks (`pde_control_tpu/control/training.py :: prepare`):
`chain(clip_by_global_norm(grad_clip), adam(lr or cosine_decay_schedule(
lr, decay_steps, alpha=0.1)))`, with optax's formulas and rounding order
(fp32, β₁ 0.9, β₂ 0.999, ε 1e-8). `torch.optim.Adam` is not used: it
cannot keep a skipped step's moments and count without a read on the
host, and its denominator rounds in another order.

The state lives on the device: the first and second moments as one flat
buffer each, over the parameters in order, and the count of applied
updates (int32). `update` returns the flat update and takes `applied`, a
0-d bool tensor: where it is False the moments and the count keep their
values and the update is zero, which is what `optax.apply_if_finite` does
with a non-finite gradient. Nothing is read back to the host, and the
state is updated in place, so the step can be captured in a CUDA graph.
optax keeps a second count for the schedule; under `apply_if_finite` the
two advance together, so one count serves both: the schedule reads it
before the increment.
"""

from __future__ import annotations

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
COSINE_ALPHA = 0.1  # the floor of the JAX package's cosine schedule


class ClippedAdam:
    def __init__(self, numel: int, device, learning_rate: float,
                 grad_clip: float | None = None,
                 decay_steps: int | None = None,
                 alpha: float = COSINE_ALPHA):
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.decay_steps = decay_steps
        self.alpha = alpha
        self.mu = torch.zeros(numel, device=device)
        self.nu = torch.zeros(numel, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def learning_rate_at(self, count: torch.Tensor):
        """The step size at `count` applied updates: the constant rate, or
        optax's `cosine_decay_schedule(lr, decay_steps, alpha)` (alpha
        0.1 by default, the training harness's floor)."""
        if not self.decay_steps:
            return self.learning_rate
        t = torch.clamp(count, max=self.decay_steps).float()
        cosine = 0.5 * (1 + torch.cos(math.pi * t / self.decay_steps))
        return self.learning_rate * ((1 - self.alpha) * cosine + self.alpha)

    def update(self, g: torch.Tensor, applied: torch.Tensor | None = None,
               norm: torch.Tensor | None = None) -> torch.Tensor:
        """The update of the flat gradient `g` (to be added to the
        parameters); advances the state where `applied` (None: always).
        `norm`: the clip's global norm when `g` is one rank's part of the
        gradient (None: `g`'s own)."""
        if self.grad_clip:
            if norm is None:
                norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.grad_clip, g, g / norm * self.grad_clip)
        count = self.count + 1
        mu = (1 - B1) * g + B1 * self.mu
        nu = (1 - B2) * (g * g) + B2 * self.nu
        t = count.float()
        mu_hat = mu / (1 - torch.pow(B1, t))
        nu_hat = nu / (1 - torch.pow(B2, t))
        step = mu_hat / (torch.sqrt(nu_hat) + EPS) * -self.learning_rate_at(
            self.count)
        if applied is not None:
            step = torch.where(applied, step, 0.0)
            mu = torch.where(applied, mu, self.mu)
            nu = torch.where(applied, nu, self.nu)
            count = torch.where(applied, count, self.count)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        self.count.copy_(count)
        return step
