"""Host milliseconds a round blocked on the device (the sum of the
program's ``wait`` spans: the readback's event waits and the collect's
blocking reads), the window's mean, from the program's round records."""
from fbench import program


def read(ctx):
    return program.span_ms(ctx, "wait")
