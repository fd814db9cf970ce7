"""Particle state and time stepping."""
