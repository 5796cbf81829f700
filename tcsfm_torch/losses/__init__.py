"""Self-supervised loss stack (counterpart of ``tcsfm.losses``)."""
