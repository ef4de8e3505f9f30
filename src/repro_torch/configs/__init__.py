"""Assigned-architecture configs (public literature) + the registry."""
from repro_torch.configs.base import ARCH_NAMES, ArchConfig, all_configs, get  # noqa: F401
