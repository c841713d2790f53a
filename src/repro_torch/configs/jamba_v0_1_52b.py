"""Config for ``jamba-v0.1-52b`` (the port of the reference's
``repro.configs.jamba_v0_1_52b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("jamba-v0.1-52b", "full")


def smoke():
    return get_config("jamba-v0.1-52b", "smoke")


config = full
