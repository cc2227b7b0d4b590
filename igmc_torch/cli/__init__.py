"""Command-line entry point: ``python -m igmc_torch.cli.main``."""
