"""Initial conditions (host-side NumPy)."""
