"""Numpy data helpers of the serving CLI (PLY I/O, resampling, normalisation)."""
