"""Utilities: dtype conversion, derivatives, linear solvers."""
