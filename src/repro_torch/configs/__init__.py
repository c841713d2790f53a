"""Architecture registry: the ten assigned archs, full and smoke
variants, the assigned shapes and the per-arch skip plan, field-identical
to the reference's ``repro.configs``."""

from .archs import ARCHS, arch_names, get_config
from .shapes import SHAPES, ShapeSpec, shape_plan

__all__ = ["ARCHS", "arch_names", "get_config", "SHAPES", "ShapeSpec",
           "shape_plan"]
