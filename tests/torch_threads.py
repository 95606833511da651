"""The port's tests' thread budget: one torch intra-op thread a process.

Test workers run side by side on the same cores (``pytest -n``). Each
worker's torch would keep an intra-op pool as wide as the machine, and the
pools together oversubscribe the cores, which makes small eager ops up to
tens of times slower. Every ``test_torch_*.py`` module imports
:func:`one_torch_thread`; pytest takes a fixture from a test module's
namespace, and ``autouse`` applies it to each of the module's tests. The
previous count comes back after the module.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
