"""Training: schedule and train step (counterpart of ``tcsfm.train``)."""
