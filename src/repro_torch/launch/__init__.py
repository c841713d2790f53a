"""Launchers: mesh construction, the dry run, the train and serve
drivers."""

from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
