"""Physics: shift advection, the pressure solve, the incompressible step."""
