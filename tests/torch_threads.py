"""Torch's CPU threads while a test file of the port runs.

The Tier-1 run puts six pytest workers on eight cores. At its default, torch
gives each worker's ops one thread per core, so the workers' threads
outnumber the cores several times over and spin waiting for each other; and
the port's tests run small tensors, which more threads do not speed up even
on an idle host: ``tests/test_torch_training.py`` alone on an eight-core
host took 232 s at the default and 152 s at two threads; later 139 s at two
threads against 138 s at one, and beside a whole Tier-1 run 161 s against
160 s. One thread leaves the other cores to the other workers.
A test module that imports ``capped_torch_threads`` runs its tests on
``THREADS`` threads and gives the worker its count back afterwards; a test
that starts a process gives it ``THREADS`` through ``OMP_NUM_THREADS``.

Importing this module also sizes XLA's CPU client for the whole pytest
process (``PJRT_NPROC``, read when the client is made at the first JAX
call; the test files import this module while they are collected, before
any test runs). By default the client runs the devices' programs on one
thread per host core. The JAX package's flash-attention tests run Pallas in
TPU interpret mode over ``tests/conftest.py``'s 8 virtual devices, where
every device's ``io_callback`` holds a pool thread while it dispatches more
work to the pool: on a host of 8 cores all 8 threads wait on each other and
``tests/test_flash_attention.py::test_shard_map_dp_tp_parity`` hangs until
the run's time limit (every time alone on an 8-core host; it passes in 8 s
with 16 threads)."""

import os

import pytest
import torch

os.environ.setdefault("PJRT_NPROC", "16")  # above the 8 virtual devices' blocked callbacks

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def capped_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)
