"""Serving artifact I/O, weight carry-over from the JAX package, the
executor chaos seam and device resolution."""
