"""Fixtures of the benchmark's own tests."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # vobench, plainref

from harness_tiny import make_checkout  # noqa: E402


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))
