"""``device_idle.train``, read in the plain training cell, whose steps spread less and
so take a bound of their own."""
from perfbench import harness

read = harness.reader("device_idle.train")
