"""The device's idle share of the traced rounds, in percent: 1 - (the
union of kernel and copy intervals) / (the rounds' host windows, from
``run_round``'s entry to the synchronize after it)."""
from fbench import readers


def read(ctx):
    return readers.idle_share(ctx)
