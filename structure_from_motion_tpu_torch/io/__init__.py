"""Data preparation of the PyTorch port (host numpy, no device code)."""
