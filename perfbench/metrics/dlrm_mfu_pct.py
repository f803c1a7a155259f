"""The whole step's share of the card's bfloat16 peak on DLRM-DCNv2: the
family's ``flops_per_example`` (96,182,784 at the published widths:
the products of the bottom MLP, the cross network and the top MLP,
forward and backward) times the traced window's examples per second,
over the peak. The reader is ``train_mfu_pct``'s."""

from perfbench.metrics import train_mfu_pct

LAYER = "whole step"
MOVES = "train_examples_per_s"

read = train_mfu_pct.read
