"""``train_tok_s``, read in the plain training cell, whose steps spread less and
so take a bound of their own."""
from perfbench import harness

read = harness.reader("train_tok_s")
