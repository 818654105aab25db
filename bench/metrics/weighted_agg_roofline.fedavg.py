"""Eq 1's kernel (``csrc/weighted_agg.cu``, ``eq1_agg_kernel``) against
its roofline, in percent, in the FedAvg cell (one model row): the benchmark's byte and
operation count of each traced eq-1 call over the kernel's device time
in the trace."""
from fbench import readers


def read(ctx):
    return readers.roofline(ctx, r"\beq1_agg_kernel\b", "eq1")
