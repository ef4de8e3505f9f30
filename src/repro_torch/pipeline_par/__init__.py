"""GPipe-style pipeline parallelism over a process group (one stage per rank)."""
from repro_torch.pipeline_par.gpipe import pipeline_apply  # noqa: F401
