"""Torch's CPU threads while a test file of the port runs.

The Tier-1 run puts six pytest workers on eight cores. At its default, torch
gives each worker's ops one thread per core, so the workers' threads
outnumber the cores several times over and spin waiting for each other; and
the port's tests run small tensors, where more than two threads buy little
even on an idle host (``tests/test_torch_training.py`` alone on an
eight-core host: 232 s at the default, 152 s at two threads). A test module
that imports ``two_torch_threads`` runs its tests on two threads and gives
the worker its count back afterwards."""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)
