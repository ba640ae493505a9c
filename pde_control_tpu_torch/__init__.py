"""pde_control_tpu_torch — the PyTorch and CUDA port of pde_control_tpu.

It mirrors the JAX package's module layout; a module here ports the module
of the same path there. Ported so far: the 64² smoke-control training
iteration (2D incompressible flow with the masked pressure solve, shift
advection, the CFE and OP networks, the staggered and chain sequences, and
the training step). The pressure solve runs as a hand-written CUDA kernel
(`csrc/pcg.cu`) for CUDA tensors and as its plain torch version on the CPU.

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
