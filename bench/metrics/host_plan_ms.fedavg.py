"""Host milliseconds a round in the control plane's plan (FedCD:
``core/plan.py`` ``RoundPlanner.build``; FedAvg: the server's one-model
``_plan``), wrapped from the benchmark, averaged over the window."""
from fbench import readers


def read(ctx):
    return readers.window(ctx, "plan_ms")
