"""Tests of the benchmark (``python -m pytest cvsbench/tests``). They run
on the CPU; a test that needs the card carries the ``card`` marker and
skips, inside the test, where there is none."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
