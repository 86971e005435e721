"""mfu_pct (%, device trace run, host clock): the model FLOPs of every chunk
of the window (each matrix and attention product, models/<model_type>.py)
over the sum of the call walls times the bf16 peak, 989 TFLOP/s."""

from h100_bench.roofline import PEAK_BF16_FLOPS


def read(run):
    walls = sum(run.walls_s())
    return 100.0 * run.model_flops() / (walls * PEAK_BF16_FLOPS) if walls > 0 else None
