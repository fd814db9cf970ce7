"""Snapshot and coefficient file I/O (NumPy; h5py imported lazily)."""
