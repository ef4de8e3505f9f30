"""Host milliseconds a traced step inside the program's
``train.grad_exchange`` span: the error feedback added, the compressed
all-reduce-mean of every leaf, the loss all-reduced, the residual kept."""
from perfbench import spans


def read(run):
    iv = spans.of(run.trace, "train.grad_exchange")
    return sum(b - a for a, b in iv) / 1e3 / len(iv) if iv else None
