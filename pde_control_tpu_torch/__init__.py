"""pde_control_tpu_torch — the PyTorch and CUDA port of pde_control_tpu.

It mirrors the JAX package's module layout; a module here ports the module
of the same path there. Ported so far: the 64² smoke-control training
iteration (2D incompressible flow with the masked pressure solve, shift
advection, inflow, the CFE and OP networks, every sequence class, and the
training step), and the staged-training entry point of the indirect
smoke-control task: geometry, dataset generation and scene trees,
checkpoints interchangeable with the JAX package's, `train()`, the
curriculum and the `experiments.run` CLI. Five hand-written CUDA kernels carry it on the card,
each with a plain torch version beside it that runs for CPU tensors:
  * K1, the pressure solve (`csrc/pcg.cu`, `ops/cuda_cg.py`), which the
    unfused step calls;
  * K2 and K3, the whole fluid step forward and its hand-written VJP
    (`csrc/fused_step.cu`, `ops/cuda_fluid.py`), which the fused step
    (`FluidConfig(fused='cuda')`) runs, one launch per step and direction;
  * K4 and K5, the 3×3 stride-1 conv's forward/dX and weight gradient
    (`csrc/conv3x3.cu`, `ops/cuda_conv.py`), which the nets run under
    `conv_impl='cuda'`.
Constructors build on the GPU unless given `device=` (`device="cpu"` for
the CPU); without a GPU they raise.

The package imports torch and numpy only, never jax or the JAX package.
"""

__version__ = "0.1.0"

from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE  # noqa: F401
from pde_control_tpu_torch.control.training import ControlTraining  # noqa: F401
from pde_control_tpu_torch.grids import Domain2D, Staggered2D  # noqa: F401
from pde_control_tpu_torch.physics.fluid import (  # noqa: F401
    FluidConfig,
    FluidState,
    divergence_free,
    fluid_step,
)
from pde_control_tpu_torch.physics.poisson import solve_pressure  # noqa: F401
from pde_control_tpu_torch.utils.convert import params_from_flax  # noqa: F401
