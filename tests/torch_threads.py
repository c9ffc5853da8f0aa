"""The port's tests' intra-op thread policy, defined once. A test module
takes it with ``from torch_threads import one_thread  # noqa: F401``: the
fixture is autouse and module-scoped, so importing it applies it to every
test of that module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (restored after): at the reduced widths the
    CPU's thread pool costs more than the arithmetic, the more so beside
    other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
