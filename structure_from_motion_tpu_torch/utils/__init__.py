"""Primitive geometry and rotation helpers of the PyTorch port."""
