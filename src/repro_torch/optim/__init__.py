"""Optimizer substrate (the port of the reference's ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, compress_int8, cosine_schedule,
                    decompress_int8, global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_int8", "cosine_schedule",
           "decompress_int8", "global_norm"]
