"""``optimizer_idle_ms.train``, read in the plain training cell, which moves
``train_tok_s.plain``."""
from perfbench import harness

read = harness.reader("optimizer_idle_ms.train")
