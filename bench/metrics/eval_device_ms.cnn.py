"""Device milliseconds a round of the validation and test accuracy
matrices (``federated/simulation.py`` ``_eval_gathered``): CUDA events
at the call's ends, averaged over the window's rounds."""
from fbench import readers


def read(ctx):
    return readers.window(ctx, "eval_ms")
