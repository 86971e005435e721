"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) and the roofline bound of a piece of work.
The arithmetic is chip_smoke.py's ``_bound``, copied."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the FLOPs at the
    peak rate and the bytes at the HBM peak."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_S)
