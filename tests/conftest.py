"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Multi-GPU hardware isn't available where the tests run; sharding and
collective paths are validated on host platform devices (SURVEY.md §4).
Two settings are needed: the XLA flag must be in the env before jax
initializes its CPU client, and the platform is forced to the CPU through
``jax.config`` so that no test ever opens an accelerator, whatever the
environment selects.  Code that needs the GPU is exercised by
``chip_smoke.py`` on the card.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import json  # noqa: E402
import pathlib  # noqa: E402

import pytest  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_core():
    with open(GOLDEN_DIR / "golden_core.json") as f:
        return json.load(f)
