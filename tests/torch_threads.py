"""One torch thread for a port test module.

The port's tests run smoke-size ops, which gain nothing from torch's
intra-op threads. Under ``pytest -n 6`` on an 8-CPU machine, six workers
that each spin a full OpenMP pool slow every one of them many times
over.

Every ``tests/test_torch_*.py`` imports the fixture below, which makes it
autouse for that module only::

    from torch_threads import one_torch_thread  # noqa: F401

It pins one thread for the module and restores the count after it, so a
worker that ``--dist loadfile`` hands other files keeps their setting.
``tests/test_torch_substrate.py`` checks that every port test file
imports it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's tests on one torch thread; restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
