"""Evaluation: VO, trajectories, depth metrics, scale recovery and the paper
experiments (counterpart of ``tcsfm.eval``)."""
