"""Spatial operators: stencils, shift sampling, spectral solves, and the
pressure-solve kernel."""
