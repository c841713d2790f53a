"""Config for ``deepseek-v2-236b`` (the port of the reference's
``repro.configs.deepseek_v2_236b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("deepseek-v2-236b", "full")


def smoke():
    return get_config("deepseek-v2-236b", "smoke")


config = full
