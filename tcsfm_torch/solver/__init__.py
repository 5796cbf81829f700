"""The coupled depth-pose solver (counterpart of ``tcsfm.solver``)."""
