"""The reference's five ``examples/`` scripts on the port, each run as
``python -m repro_torch.examples.<name> [--device D]``."""
