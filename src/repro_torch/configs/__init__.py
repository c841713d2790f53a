"""Architecture registry: the ten assigned archs, full and smoke
variants, field-identical to the reference's ``repro.configs``."""

from .archs import ARCHS, arch_names, get_config

__all__ = ["ARCHS", "arch_names", "get_config"]
