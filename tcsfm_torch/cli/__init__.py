"""Command-line entry points (counterpart of ``tcsfm.cli``)."""
