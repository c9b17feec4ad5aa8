"""Synthetic spike datasets (numpy-only copies of `repro.data`)."""
