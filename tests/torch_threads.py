"""The thread cap every `tests/test_torch_*.py` module imports.

The suite runs under `pytest -n 6 --dist loadfile`: six worker processes on
the machine's cores at once, each with torch's full OpenMP team beside XLA's
own pool. So oversubscribed, a torch-heavy test runs 15-40 times slower than
alone. Two intra-op threads a process keep each file's time near what it
takes alone, whatever runs next to it. Imports torch only (no jax), so card-only
test modules can import it on a machine without jax.
"""
import pytest
import torch

__all__ = ['two_torch_threads']


@pytest.fixture(autouse=True, scope='module')
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
