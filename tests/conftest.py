"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so the full engine —
including multi-device sharding — executes without a GPU (SURVEY.md §4:
this deliberately exceeds the reference, whose GPU tests could not run
in its own CI).  Set WARPDB_TEST_GPU=1 to run on the attached GPU
instead.  Tests marked ``gpu`` need a card: they skip on any other
backend, decided per test by the fixture below, never at import.
"""

import os

import jax

if not os.environ.get("WARPDB_TEST_GPU"):
    # Through the config API, before any backend initialises, so the
    # virtual device count applies even when JAX_PLATFORMS is unset.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
else:
    from warpdb_tpu.config import configure_compilation_cache

    configure_compilation_cache()

import pathlib

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return REPO_ROOT / "data"


@pytest.fixture(autouse=True)
def _chdir_repo_root(monkeypatch):
    """Run every test from the repo root (relative data paths, custom.py
    discovery — mirroring the reference tests' run-from-repo-root rule)."""
    monkeypatch.chdir(REPO_ROOT)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked ``gpu`` unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: WARPDB_TEST_GPU=1 pytest -m gpu")
