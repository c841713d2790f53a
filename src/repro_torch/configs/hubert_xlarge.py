"""Config for ``hubert-xlarge`` (the port of the reference's
``repro.configs.hubert_xlarge``).

Exact published hyper-parameters; see ``repro_torch.configs.archs`` for
the source notes and the reduced smoke variant.
"""

from .archs import get_config


def full():
    return get_config("hubert-xlarge", "full")


def smoke():
    return get_config("hubert-xlarge", "smoke")


config = full
