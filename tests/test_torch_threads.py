"""The fixture every ``tests/test_torch_*.py`` file imports: one torch
intra-op thread in the pytest worker, and ``OMP_NUM_THREADS=1`` for the
processes its tests start, for as long as the file's tests run.

The suite runs six xdist workers on one host, and torch starts one
intra-op thread per core in each: with the other workers busy, a tiny
train step took 3.3 s with eight threads and 0.04 s with one. The
fixture puts both settings back after the file. A test whose bound was
set in the summation order of torch's default thread count asks for
``default_torch_threads`` and runs with it. This module holds no tests.
"""

import os

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()  # the worker's, before any fixture


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture
def default_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
