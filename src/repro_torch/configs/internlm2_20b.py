"""Config for ``internlm2-20b`` (the port of the reference's
``repro.configs.internlm2_20b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("internlm2-20b", "full")


def smoke():
    return get_config("internlm2-20b", "smoke")


config = full
