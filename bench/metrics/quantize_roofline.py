"""The transport kernels (``csrc/quantize.cu``: ``quantize_kernel`` and
``dequantize_kernel`` together, one round trip of the aggregated rows)
against their roofline, in percent: the benchmark's byte count of each
traced round trip over the two kernels' device time in the trace.
FedAvg ships no int8, so it reads nothing there."""
from fbench import readers


def read(ctx):
    return readers.roofline(ctx, r"\b(de)?quantize_kernel\b", "quant")
