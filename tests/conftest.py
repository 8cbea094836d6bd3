"""Test config: run the suite on a simulated 8-device CPU backend.

Must run before any test imports jax (SURVEY.md §4: the standard JAX
fake-backend technique for testing multi-device sharding without a
mesh of cards). JAX_PLATFORMS defaults to cpu here; the card-only tests
(marker `gpu`) run on the card with `JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/test_pallas_estep.py`, and decide in a fixture
whether a card is there.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if os.environ["JAX_PLATFORMS"] == "cpu":
    assert jax.device_count() == 8, jax.devices()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
