"""Signals: reductions and models."""
