"""Host milliseconds a round in the pair trainer's dispatch (the
program's ``launch/train`` span: ``_dispatch_train``'s call into the
step loop of ``federated/simulation.py`` ``_pair_train``, or taking the
speculation), the window's mean, from the program's round records."""
from fbench import program


def read(ctx):
    return program.span_ms(ctx, "launch/train")
