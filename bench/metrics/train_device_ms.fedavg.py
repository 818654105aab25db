"""Device milliseconds a round of the pair training
(``federated/simulation.py`` ``_pair_train``): CUDA events at the
call's ends, averaged over the window's rounds."""
from fbench import readers


def read(ctx):
    return readers.window(ctx, "train_ms")
