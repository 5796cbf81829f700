"""Camera, SE(3) and warp geometry (counterpart of ``tcsfm.geom``)."""
