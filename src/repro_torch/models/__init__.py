"""Model layers and assembly: GQA and MLA attention (decode and the
full-sequence forward), Mamba, MoE and xLSTM layers, and the transformer
stack of all ten archs (dense GQA, jamba's hybrid, mixtral's MoE,
deepseek-v2's MLA with its dense prefix, xlstm's mLSTM and sLSTM).

The names match the reference's ``repro.models``.
"""

from . import transformer
from .common import ModelConfig
from .transformer import (count_params, decode_step, forward, init,
                          init_cache, model_flops, prefill, unit_period)

__all__ = ["ModelConfig", "transformer", "count_params", "decode_step",
           "forward", "init", "init_cache", "model_flops", "prefill",
           "unit_period"]
