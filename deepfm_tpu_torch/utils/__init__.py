"""Serving artifact I/O, checkpoints, weight and optimizer-state carry-over
from the JAX package, the throughput meter, the executor chaos seam and
device resolution."""
