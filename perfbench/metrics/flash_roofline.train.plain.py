"""``flash_roofline.train``, read in the plain training cell, whose steps spread less and
so take a bound of their own."""
from perfbench import harness

read = harness.reader("flash_roofline.train")
