"""The device's idle milliseconds a traced step inside the program's
``train.optimizer`` span (``AdamW.update``)."""
from perfbench import spans


def read(run):
    ms = spans.idle_ms(run.trace, "train.optimizer")
    return sum(ms) / len(ms) if ms else None
