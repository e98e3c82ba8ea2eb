"""Treecode core: space, kernels, interpolation, host planner, executor
and the public solver API."""
