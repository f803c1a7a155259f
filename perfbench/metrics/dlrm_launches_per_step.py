"""Device kernels launched in DLRM-DCNv2's traced window, per optimizer
step: 26 tables' plans, gathers, takes and row updates make the host
launch several hundred a step. The reader is
``train_launches_per_step``'s."""

from perfbench.metrics import train_launches_per_step

LAYER = "fit loop and dispatch (train/loop.py)"
MOVES = "train_examples_per_s"

read = train_launches_per_step.read
