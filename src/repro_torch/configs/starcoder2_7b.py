"""Config for ``starcoder2-7b`` (the port of the reference's
``repro.configs.starcoder2_7b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("starcoder2-7b", "full")


def smoke():
    return get_config("starcoder2-7b", "smoke")


config = full
