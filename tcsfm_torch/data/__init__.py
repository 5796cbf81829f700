"""Data pipeline: sequences, windows, transforms, loader and synthetic
sequences (numpy; copies of ``tcsfm.data``'s modules, imports rewritten)."""
