"""Steady-state solver (single-attempt pseudo-transient continuation)."""
