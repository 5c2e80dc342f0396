"""GaussianField: trainable Gaussian-mixture field parameterization.

The reference takes covariances/conics as raw inputs and produces gradients
w.r.t. the conic; the chain to scales/rotations "happens in Python (in PIGS,
outside this repo)" (SURVEY.md section 0).  Here that chain is part of the
framework: a pytree of (means, log_scales, rotations, values) with
differentiable covariance/conic construction, so dL/dconic from the sampling
ops flows to scales and rotations by autodiff.

Parameterization: cov = R diag(exp(2*log_scales)) R^T, conic = cov^{-1} =
R diag(exp(-2*log_scales)) R^T - always SPD, never needs the det==0 cull.
Rotations: D=1 none, D=2 angle, D=3 unit quaternion.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp



class GaussianField(NamedTuple):
    means: jnp.ndarray       # (P, D)
    log_scales: jnp.ndarray  # (P, D)
    rotations: jnp.ndarray   # (P, 0) D=1 / (P, 1) angle D=2 / (P, 4) quat D=3
    values: jnp.ndarray      # (P, C)

    @property
    def P(self) -> int:
        return self.means.shape[0]

    @property
    def D(self) -> int:
        return self.means.shape[1]

    def rotation_matrices(self) -> jnp.ndarray:  # (P, D, D)
        D = self.D
        P = self.P
        if D == 1:
            return jnp.ones((P, 1, 1), self.means.dtype)
        if D == 2:
            t = self.rotations[:, 0]
            c, s = jnp.cos(t), jnp.sin(t)
            return jnp.stack(
                [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2
            )
        if D == 3:
            q = self.rotations / (
                jnp.linalg.norm(self.rotations, axis=-1, keepdims=True) + 1e-12
            )
            w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
            return jnp.stack(
                [
                    jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                    jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                    jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
                ],
                -2,
            )
        raise ValueError(f"unsupported D={self.D}")

    def _packed_quadratic(self, eigs: jnp.ndarray) -> jnp.ndarray:
        """Packed upper-triangular R diag(eigs) R^T.

        Unrolled elementwise over D<=3: exact fp32 arithmetic on (P,)
        arrays, where a batched einsum of DxD matrices would be a matrix
        product at the backend's default (reduced) precision."""
        R = self.rotation_matrices()
        D = self.D
        cols = [
            sum(R[:, i, k] * eigs[:, k] * R[:, j, k] for k in range(D))
            for i in range(D)
            for j in range(i, D)
        ]
        return jnp.stack(cols, axis=-1)

    def covariances(self) -> jnp.ndarray:  # (P, tri)
        return self._packed_quadratic(jnp.exp(2.0 * self.log_scales))

    def conics(self) -> jnp.ndarray:  # (P, tri)
        return self._packed_quadratic(jnp.exp(-2.0 * self.log_scales))


def init_field(key, P: int, D: int, C: int, *,
               sigma: float = 0.05, value_scale: float = 0.1,
               lower: float = -1.0, upper: float = 1.0) -> GaussianField:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    means = jax.random.uniform(k1, (P, D), minval=lower, maxval=upper)
    log_scales = jnp.log(sigma) + 0.2 * jax.random.normal(k2, (P, D))
    if D == 1:
        rotations = jnp.zeros((P, 0))
    elif D == 2:
        rotations = jax.random.uniform(k3, (P, 1), maxval=2 * jnp.pi)
    else:
        rotations = jax.random.normal(k3, (P, 4))
    values = value_scale * jax.random.normal(k4, (P, C))
    return GaussianField(
        means.astype(jnp.float32),
        log_scales.astype(jnp.float32),
        rotations.astype(jnp.float32),
        values.astype(jnp.float32),
    )
