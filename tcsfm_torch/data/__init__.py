"""Data pipeline: sequences, windows, transforms, loader, synthetic
sequences, the KITTI and ScanNet readers and the preprocessing CLI (numpy;
copies of ``tcsfm.data``'s modules, imports rewritten)."""
