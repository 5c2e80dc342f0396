"""Test harness configuration.

Forces an 8-device virtual CPU mesh so sharding tests run without several
cards (SURVEY.md section 4: fake an N-device mesh via
``--xla_force_host_platform_device_count``).  Must run before jax is
imported.  On the CPU the pair kernels run in the Pallas interpreter.

Tests marked ``gpu`` need a card: they ask for the ``gpu_device`` fixture,
which skips when JAX has no GPU.  The decision is made inside the fixture,
never at import, so every pytest-xdist worker collects the same tests.
chip_smoke.py runs them on the card in its own process.
"""

import os
import sys

# A process that imported JAX before pytest (chip_smoke.py on the card)
# keeps its devices; a plain pytest run gets the virtual CPU mesh.
if "jax" not in sys.modules:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card via chip_smoke.py)")
    return jax.devices()[0]


def make_gaussians(rng, P, D, C, *, sigma_range=(0.02, 0.2), dtype=np.float32):
    """Random well-conditioned anisotropic Gaussians on [-1, 1]^D.

    Returns (means, values, covariances, conics) with the packed-triangular
    layout of the reference (sample_points.cu:167).
    """
    from dgs.config import tri_size

    means = rng.uniform(-1.0, 1.0, (P, D)).astype(dtype)
    values = rng.normal(0.0, 1.0, (P, C)).astype(dtype)
    # Random SPD covariance via A A^T scaled into sigma_range.
    covs = np.zeros((P, tri_size(D)), dtype)
    conics = np.zeros((P, tri_size(D)), dtype)
    for p in range(P):
        A = rng.normal(0.0, 1.0, (D, D))
        S = A @ A.T + np.eye(D) * 0.3
        # scale so sqrt(max eigenvalue) lands in sigma_range
        lam = np.linalg.eigvalsh(S).max()
        target = rng.uniform(*sigma_range) ** 2
        S *= target / lam
        Sinv = np.linalg.inv(S)
        k = 0
        for i in range(D):
            for j in range(i, D):
                covs[p, k] = S[i, j]
                conics[p, k] = Sinv[i, j]
                k += 1
    return means, values, covs, conics


def make_samples(rng, N, D, dtype=np.float32):
    return rng.uniform(-1.0, 1.0, (N, D)).astype(dtype)


@pytest.fixture
def gaussians_factory():
    return make_gaussians


@pytest.fixture
def samples_factory():
    return make_samples
