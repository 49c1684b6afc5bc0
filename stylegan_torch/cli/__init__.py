"""Command-line entry points: ``python -m stylegan_torch.cli.<name>``."""
