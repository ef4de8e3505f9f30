"""The device's idle milliseconds a traced step inside the program's
``train.grad_exchange`` span."""
from perfbench import spans


def read(run):
    ms = spans.idle_ms(run.trace, "train.grad_exchange")
    return sum(ms) / len(ms) if ms else None
