"""Launchers: the device mesh, the sharding plan, the train CLI and the
dry-run, PyTorch port of ``repro.launch``."""
