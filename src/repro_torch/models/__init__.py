"""Model layers and assembly: GQA and MLA attention (decode and the
full-sequence forward), Mamba and MoE layers, and the transformer stack
of every arch the port runs (dense GQA, jamba's hybrid, mixtral's MoE,
deepseek-v2's MLA with its dense prefix).

The names match the reference's ``repro.models`` (``model_flops`` waits
for the roofline slice); xLSTM configs raise in
``transformer.check_supported``.
"""

from . import transformer
from .common import ModelConfig
from .transformer import (count_params, decode_step, forward, init,
                          init_cache, prefill, unit_period)

__all__ = ["ModelConfig", "transformer", "count_params", "decode_step",
           "forward", "init", "init_cache", "prefill", "unit_period"]
