"""Percent of the pair trainer's rows that were bucket padding over the
window: 100 x the program's ``pairs_padded`` counts over ``pairs`` +
``pairs_padded`` (every train dispatch, speculative ones included)."""
from fbench import program


def read(ctx):
    return program.pad_share(ctx)
