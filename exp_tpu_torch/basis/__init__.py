"""Host-side basis builders (NumPy/SciPy) and their tensor bundles."""
