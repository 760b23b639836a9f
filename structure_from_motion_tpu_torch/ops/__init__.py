"""Batched geometry, frontend, matching and bundle-adjustment ops of the
PyTorch port, with the hand-written Hopper kernels behind ``*_cuda.py`` and
``matching.match_top2``."""
