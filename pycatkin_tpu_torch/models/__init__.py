"""Reactor models and the seeded synthetic mechanism generator."""
