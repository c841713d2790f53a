"""Config for ``mistral-nemo-12b`` (the port of the reference's
``repro.configs.mistral_nemo_12b``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("mistral-nemo-12b", "full")


def smoke():
    return get_config("mistral-nemo-12b", "smoke")


config = full
