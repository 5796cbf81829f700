"""Numeric helpers (counterpart of ``tcsfm.utils``)."""
