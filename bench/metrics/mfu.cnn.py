"""The whole round's share of the H100's float32 peak (67 TFLOP/s; the
cells run float32 with TF32 off), in percent: the benchmark's own count
of the CNN's FLOPs (forward and backward of every sample trained, the
forward of every sample evaluated, from the layer shapes and each
round's plan) over the window's round walls."""
from fbench import readers


def read(ctx):
    return readers.mfu(ctx)
