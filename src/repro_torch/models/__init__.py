"""Model layers and assembly (dense GQA decode path)."""

from .common import ModelConfig

__all__ = ["ModelConfig"]
