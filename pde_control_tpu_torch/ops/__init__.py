"""Spatial operators (stencils, shift sampling, spectral solves) and the
CUDA kernels' wrappers: the pressure solve, the fused fluid step and the
3×3 conv."""
