"""Config for ``mixtral-8x7b`` (the port of the reference's
``repro.configs.mixtral_8x7b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("mixtral-8x7b", "full")


def smoke():
    return get_config("mixtral-8x7b", "smoke")


config = full
