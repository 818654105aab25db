"""Convolution kernel calls a round (the program's ``conv_launches``
counter: ``kernels/conv3x3`` counts each forward, dgrad and wgrad call on
the card; a wgrad's split-K pass is part of its call), the window's
mean. A program without the counter reads nothing."""
from fbench import program


def read(ctx):
    recs = program.window(ctx)
    if recs is None or not any("conv_launches" in r.counters for r in recs):
        return None
    return program.counter(ctx, "conv_launches")
