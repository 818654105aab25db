"""Model rows a round scored on every device's split (the program's
``eval_rows`` counter: ``federated/simulation.py`` ``_eval_gathered``'s
rows, padding and unread rows included), the window's mean."""
from fbench import program


def read(ctx):
    return program.counter(ctx, "eval_rows")
