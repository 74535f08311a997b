"""Visualization helpers (counterpart of ``difficp_tpu/viz``).  Matplotlib is
imported lazily, inside the plotting functions only: building and warping
grids, and the bounds, run without it."""
