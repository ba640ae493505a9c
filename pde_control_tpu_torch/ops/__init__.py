"""Spatial operators (stencils, shift sampling, spectral solves) and the
CUDA kernels' wrappers: the pressure solve, the fused fluid step and the
3×3 conv."""


def launch_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters, by kernel: K1, K2, K3, K4's
    forward and dX, K5."""
    from pde_control_tpu_torch.ops import cuda_cg, cuda_conv, cuda_fluid

    return {"K1": cuda_cg.LAUNCHES, "K2": cuda_fluid.LAUNCHES_FWD,
            "K3": cuda_fluid.LAUNCHES_BWD, "K4 fwd": cuda_conv.LAUNCHES_FWD,
            "K4 dX": cuda_conv.LAUNCHES_DX, "K5": cuda_conv.LAUNCHES_DW}
