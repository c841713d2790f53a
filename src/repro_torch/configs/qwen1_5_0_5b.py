"""Config for ``qwen1.5-0.5b`` (the port of the reference's
``repro.configs.qwen1_5_0_5b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("qwen1.5-0.5b", "full")


def smoke():
    return get_config("qwen1.5-0.5b", "smoke")


config = full
