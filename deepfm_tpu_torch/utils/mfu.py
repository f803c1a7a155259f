"""MFU (model FLOPs utilization) with an explicit basis label (the port's
copy of ``deepfm_tpu.utils.mfu``, with the card's own peak table).

An MFU number means something only beside the peak it is divided by:

- On a recognized card, the divisor is its dense BF16 tensor-core peak from
  the vendor's datasheet: basis ``measured-device-peak``.
- On the CPU there is no datasheet peak; the divisor is a labelled nominal
  host estimate: basis ``nominal-estimate``. Such a number is an order of
  magnitude only.
- On any other card the answer is no number at all: basis
  ``unavailable`` with a null MFU, never a guess.

Every MFU a benchmark emits carries its basis beside it, so a consumer can
refuse to average a device-peak MFU with a nominal one.
"""

from __future__ import annotations

from typing import Optional, Tuple

# Basis labels, stamped next to every emitted MFU value.
BASIS_MEASURED = "measured-device-peak"
BASIS_NOMINAL = "nominal-estimate"
BASIS_UNAVAILABLE = "unavailable"

# Dense BF16 tensor-core peak FLOP/s per card, matched by substring against
# torch.cuda.get_device_name() in this order (the PCIe entry before the SXM
# ones: "H100 PCIe" must not fall through to an SXM key). The figures are
# NVIDIA's "H100 Tensor Core GPU" datasheet's BF16 Tensor Core rows, which
# are quoted with sparsity (1,979 TFLOPS SXM, 1,513 TFLOPS PCIe); the dense
# peak is half of each.
PEAK_FLOPS_BF16 = (
    ("h100 pcie", 756.5e12),
    ("h100 80gb hbm3", 989.5e12),
    ("h100 sxm", 989.5e12),
)

# Nominal single-host CPU peak for the labelled CPU estimate: a few AVX2
# cores' worth of fp32 FMA (~1e11 FLOP/s). Deliberately coarse; the basis
# label marks every number derived from it as an estimate.
NOMINAL_CPU_PEAK_FLOPS = 1e11


def peak_for_name(name: str) -> Tuple[Optional[float], str]:
    """(peak_or_None, basis) for a card named ``name``."""
    low = name.lower()
    for key, peak in PEAK_FLOPS_BF16:
        if key in low:
            return peak, BASIS_MEASURED
    return None, BASIS_UNAVAILABLE


def device_peak_flops(device="cuda") -> Tuple[Optional[float], str, str]:
    """(peak_flops_or_None, device_name, basis) of ``device``.

    A card in the table gets (peak, name, BASIS_MEASURED); the CPU gets the
    labelled nominal estimate; any other card (None, name,
    BASIS_UNAVAILABLE)."""
    import torch  # noqa: PLC0415 (the table and the CPU need no torch)
    dev = torch.device(device)
    if dev.type == "cpu":
        return NOMINAL_CPU_PEAK_FLOPS, "cpu", BASIS_NOMINAL
    if dev.type != "cuda":
        return None, dev.type, BASIS_UNAVAILABLE
    name = torch.cuda.get_device_name(dev)
    peak, basis = peak_for_name(name)
    return peak, name, basis


def mfu_pct(flops_per_example: float, examples_per_sec_per_chip: float,
            device="cuda") -> Tuple[Optional[float], str, str]:
    """(mfu_pct_or_None, basis, device_name) of an achieved throughput on
    ``device``: a percentage of its peak; None (basis ``unavailable``)
    when no peak, measured or nominal, exists."""
    peak, name, basis = device_peak_flops(device)
    if peak is None:
        return None, basis, name
    pct = 100.0 * flops_per_example * examples_per_sec_per_chip / peak
    return round(pct, 4), basis, name
