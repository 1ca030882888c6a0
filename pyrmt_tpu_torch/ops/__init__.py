"""Operators of the port: stencils, sampling, advection, extrapolation,
stress, level sets and the Poisson projection."""
