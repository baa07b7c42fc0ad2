"""Single-device batched runners of the PyTorch port."""
