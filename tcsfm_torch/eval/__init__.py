"""Evaluation: scale recovery and the paper experiments (counterpart of ``tcsfm.eval``)."""
