"""Track store and the incremental SfM engine of the PyTorch port."""
