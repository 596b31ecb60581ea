"""A module-scoped fixture that runs a test module on one intra-op thread.

Import it into a module (``from ._threads import one_thread  # noqa``) whose
pipelines are thousands of small ops: more threads do not speed those up,
while threads that spin slow the other workers of a parallel test run."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
