"""Depth and pose networks (counterpart of ``tcsfm.models``)."""
