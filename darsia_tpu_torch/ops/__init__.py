"""Tensor operations: warps (with the two-pass kernel), FFT, solvers, color."""
