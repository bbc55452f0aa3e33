"""The whole step's share of the card's fp32 peak: the benchmark's own
model FLOPs of a step (``bench.yardstick``) over the window's step time
and 67 TFLOP/s."""
from bench import yardstick


def read(run):
    return 100.0 * run.flops_per_step / run.step_s / yardstick.PEAK_FLOPS_FP32
