"""Config for ``xlstm-125m`` (the port of the reference's
``repro.configs.xlstm_125m``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("xlstm-125m", "full")


def smoke():
    return get_config("xlstm-125m", "smoke")


config = full
