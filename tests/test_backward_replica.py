"""Numpy transcription of the reference backward kernels as a test oracle.

The aggregation subsystem pins reference semantics with a numpy replica of
aggregate_neighbors.cu (test_aggregation.py); this file does the same for the
sampling backward: the per-pair closed forms of
/root/reference/cuda_sampler/backward.cu:108-416 (gaussian /
gaussian_derivative / gaussian_laplacian / gaussian_third, D in {1, 2})
transcribed literally (atomicAdd -> +=), looped over exactly the pairs the
binning produces.  The tiled Pallas path's custom-VJP gradients must match
this replica - closing the "grads allclose vs CUDA reference semantics" gate
without CUDA hardware.

Layout notes pinned by the replica:
  * cotangents arrive over the FULL row-major tensors (D^k components, the
    symmetric duplicates each carrying their own cotangent - backward.cu
    reads dL_dout_values[(sample*D*D + comp)*C + ch] for all D*D comps);
  * the reference returns -dL_dx into dL_dmeans (backward.cu:129, 147-148)
    and hand-derived packed-triangular conic gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.binning import grid as binning
from dgs.ops import sampling

from conftest import make_gaussians, make_samples


def _wrap(X):
    # TORUS wrap of backward.cu:89-97 (period 2, branch on |X| > 1).
    X = np.where(np.abs(X) > 1.0,
                 np.where(X >= 0, np.fmod(X, 2.0) - 2.0,
                          np.fmod(X, 2.0) + 2.0), X)
    return X


def _bwd_value(X, con, value, g, dmu, dval, dcon, D):
    """backward.cu gaussian() (lines 108-154).  g is (C,) for this sample."""
    if D == 1:
        power = -0.5 * con[0] * X[0] * X[0]
        if power > 0.0:
            return
        G = np.exp(power)
        dL_dG = 0.0
        for ch in range(len(value)):
            dval[ch] += G * g[0, ch]
            dL_dG += value[ch] * g[0, ch]
        gdx = G * X[0]
        dL_dx = dL_dG * (gdx * con[0])
        dmu[0] += -dL_dx
        dcon[0] += -0.5 * gdx * X[0] * dL_dG
    else:
        power = (-0.5 * (con[0] * X[0] * X[0] + con[2] * X[1] * X[1])
                 - con[1] * X[0] * X[1])
        if power > 0.0:
            return
        G = np.exp(power)
        dL_dG = 0.0
        for ch in range(len(value)):
            dval[ch] += G * g[0, ch]
            dL_dG += value[ch] * g[0, ch]
        gdx, gdy = G * X[0], G * X[1]
        dmu[0] += -dL_dG * (gdx * con[0] + gdy * con[1])
        dmu[1] += -dL_dG * (gdx * con[1] + gdy * con[2])
        dcon[0] += -0.5 * gdx * X[0] * dL_dG
        dcon[1] += -gdy * X[0] * dL_dG
        dcon[2] += -0.5 * gdy * X[1] * dL_dG


def _bwd_derivative(X, con, value, g, dmu, dval, dcon, D):
    """backward.cu gaussian_derivative() (lines 156-210).  g is (D, C)."""
    if D == 1:
        x1 = con[0] * X[0]
        power = -0.5 * x1 * X[0]
        if power > 0.0:
            return
        G = np.exp(power)
        dL_dG = 0.0
        for ch in range(len(value)):
            dval[ch] += x1 * g[0, ch] * G
            dL_dG += value[ch] * g[0, ch]
        dL_dx = (x1 * x1 - con[0]) * dL_dG * G
        dmu[0] += -dL_dx
        dcon[0] += (X[0] - 0.5 * X[0] * X[0] * x1) * dL_dG * G
    else:
        x1, x2 = con[0] * X[0], con[2] * X[1]
        power = -0.5 * (x1 * X[0] + x2 * X[1]) - con[1] * X[0] * X[1]
        if power > 0.0:
            return
        G = np.exp(power)
        a1 = x1 + con[1] * X[1]
        a2 = x2 + con[1] * X[0]
        dL_dGx = dL_dGy = 0.0
        for ch in range(len(value)):
            gx = a1 * g[0, ch] + a2 * g[1, ch]
            dval[ch] += gx * G
            dL_dGx += value[ch] * g[0, ch]
            dL_dGy += value[ch] * g[1, ch]
        gx = a1 * dL_dGx + a2 * dL_dGy
        dmu[0] += -((a1 * a1 - con[0]) * dL_dGx
                    + (a1 * a2 - con[1]) * dL_dGy) * G
        dmu[1] += -((a2 * a2 - con[2]) * dL_dGy
                    + (a1 * a2 - con[1]) * dL_dGx) * G
        dcon[0] += (X[0] * dL_dGx - 0.5 * X[0] * X[0] * gx) * G
        dcon[1] += (X[1] * dL_dGx + X[0] * dL_dGy - X[0] * X[1] * gx) * G
        dcon[2] += (X[1] * dL_dGy - 0.5 * X[1] * X[1] * gx) * G


def _bwd_laplacian(X, con, value, g, dmu, dval, dcon, D):
    """backward.cu gaussian_laplacian() (lines 212-298).  g is (D*D, C)."""
    if D == 1:
        x1 = con[0] * X[0]
        power = -0.5 * x1 * X[0]
        if power > 0.0:
            return
        G = np.exp(power)
        dL_dG = 0.0
        for ch in range(len(value)):
            dval[ch] += (x1 * x1 - con[0]) * g[0, ch] * G
            dL_dG += value[ch] * g[0, ch]
        dmu[0] += -(x1 * x1 * x1 - 3.0 * con[0] * x1) * dL_dG * G
        dcon[0] += (2.0 * x1 * X[0]
                    - 0.5 * (x1 * x1 - con[0]) * X[0] * X[0]
                    - 1.0) * dL_dG * G
    else:
        x1, x2 = con[0] * X[0], con[2] * X[1]
        power = -0.5 * (x1 * X[0] + x2 * X[1]) - con[1] * X[0] * X[1]
        if power > 0.0:
            return
        G = np.exp(power)
        a1 = x1 + con[1] * X[1]
        a2 = x2 + con[1] * X[0]
        dxx = a1 * a1 - con[0]
        dxy = a1 * a2 - con[1]
        dyy = a2 * a2 - con[2]
        dGxx = dGxy = dGyx = dGyy = 0.0
        for ch in range(len(value)):
            gxx = (dxx * g[0, ch] + dxy * g[1, ch]
                   + dxy * g[2, ch] + dyy * g[3, ch])
            dval[ch] += gxx * G
            dGxx += value[ch] * g[0, ch]
            dGxy += value[ch] * g[1, ch]
            dGyx += value[ch] * g[2, ch]
            dGyy += value[ch] * g[3, ch]
        dmu[0] += -((a1 * a1 * a1 - 3.0 * con[0] * a1) * dGxx
                    + (a1 * a2 * a1 - con[1] * a1
                       - (con[1] * a1 + con[0] * a2)) * (dGxy + dGyx)
                    + (a2 * a2 * a1 - con[2] * a1
                       - 2.0 * con[1] * a2) * dGyy) * G
        dmu[1] += -((a1 * a1 * a2 - con[0] * a2 - 2.0 * con[1] * a1) * dGxx
                    + (a1 * a2 * a2 - con[1] * a2
                       - (con[2] * a1 + con[1] * a2)) * (dGxy + dGyx)
                    + (a2 * a2 * a2 - 3.0 * con[2] * a2) * dGyy) * G
        dVxx_dcxx = -0.5 * dxx * X[0] * X[0] + 2.0 * a1 * X[0] - 1.0
        dVxy_dcxx = -0.5 * dxy * X[0] * X[0] + a2 * X[0]
        dVyy_dcxx = -0.5 * dyy * X[0] * X[0]
        dVxx_dcxy = -dxx * X[0] * X[1] + 2.0 * a1 * X[1]
        dVxy_dcxy = -dxy * X[0] * X[1] + a2 * X[1] + a1 * X[0] - 1.0
        dVyy_dcxy = -dyy * X[0] * X[1] + 2.0 * a2 * X[0]
        dVxx_dcyy = -0.5 * dxx * X[1] * X[1]
        dVxy_dcyy = -0.5 * dxy * X[1] * X[1] + a1 * X[1]
        dVyy_dcyy = -0.5 * dyy * X[1] * X[1] + 2.0 * a2 * X[1] - 1.0
        hxy = dGxy + dGyx
        dcon[0] += (dVxx_dcxx * dGxx + dVxy_dcxx * hxy + dVyy_dcxx * dGyy) * G
        dcon[1] += (dVxx_dcxy * dGxx + dVxy_dcxy * hxy + dVyy_dcxy * dGyy) * G
        dcon[2] += (dVxx_dcyy * dGxx + dVxy_dcyy * hxy + dVyy_dcyy * dGyy) * G


def _bwd_third(X, con, value, g, dmu, dval, dcon, D):
    """backward.cu gaussian_third() (lines 300-416).  g is (D^3, C)."""
    if D == 1:
        x1 = con[0] * X[0]
        power = -0.5 * x1 * X[0]
        if power > 0.0:
            return
        G = np.exp(power)
        dL_dG = 0.0
        for ch in range(len(value)):
            dval[ch] += (3.0 * con[0] * x1 - x1 * x1 * x1) * g[0, ch] * G
            dL_dG += value[ch] * g[0, ch]
        dmu[0] += -(6.0 * con[0] * x1 * x1 - x1 ** 4
                    - 3.0 * con[0] * con[0]) * dL_dG * G
        # DOCUMENTED REFERENCE DEFECT: backward.cu:322-325's dV_dc
        #   (2 X^2 - 2 x1^2 X - 0.5 (2 X x1 - X) X^2
        #    + 0.5 (x1^2 - c) x1 X^2) * dL_dG * G
        # disagrees with d/dc [G (3 c x1 - x1^3)] (finite differences and
        # sympy both reject it; see test_reference_third_d1_dconic_is_wrong).
        # The replica uses the correct closed form G (s p + dp/dc) with
        # s = -0.5 X^2, p = 3 c x1 - x1^3, dp/dc = 6 x1 - 3 x1^2 X, which is
        # what ops/formulas.py implements (locked to autodiff).
        p = 3.0 * con[0] * x1 - x1 ** 3
        dcon[0] += (-0.5 * X[0] * X[0] * p
                    + 6.0 * x1 - 3.0 * x1 * x1 * X[0]) * dL_dG * G
    else:
        x1, x2 = con[0] * X[0], con[2] * X[1]
        power = -0.5 * (x1 * X[0] + x2 * X[1]) - con[1] * X[0] * X[1]
        if power > 0.0:
            return
        G = np.exp(power)
        a1 = x1 + con[1] * X[1]
        a2 = x2 + con[1] * X[0]
        dxxx = 3.0 * con[0] * a1 - a1 ** 3
        dxxy = 2.0 * con[1] * a1 - a1 * a1 * a2 + con[0] * a2
        dxyy = 2.0 * con[1] * a2 - a1 * a2 * a2 + con[2] * a1
        dyyy = 3.0 * con[2] * a2 - a2 ** 3
        dG = np.zeros(8)
        w = [dxxx, dxxy, dxxy, dxyy, dxxy, dxyy, dxyy, dyyy]
        for ch in range(len(value)):
            gxx = sum(w[i] * g[i, ch] for i in range(8))
            dval[ch] += gxx * G
            for i in range(8):
                dG[i] += value[ch] * g[i, ch]
        dxxy_dx = (2.0 * a1 * a2 * con[0] + a1 * a1 * con[1]
                   - 3.0 * con[0] * con[1])
        dxyy_dx = (2.0 * a1 * a2 * con[1] + a2 * a2 * con[0]
                   - con[2] * con[0] - 2.0 * con[1] * con[1])
        dmu[0] += -((dxxx * a1 - 3.0 * con[0] ** 2 + 3.0 * a1 * a1 * con[0])
                    * dG[0]
                    + (dxxy * a1 + dxxy_dx) * (dG[1] + dG[2] + dG[4])
                    + (dxyy * a1 + dxyy_dx) * (dG[3] + dG[5] + dG[6])
                    + (dyyy * a1 - 3.0 * con[2] * con[1]
                       + 3.0 * a2 * a2 * con[1]) * dG[7]) * G
        dxxy_dy = (2.0 * a1 * a2 * con[1] + a1 * a1 * con[2]
                   - con[0] * con[2] - 2.0 * con[1] * con[1])
        dxyy_dy = (2.0 * a1 * a2 * con[2] + a2 * a2 * con[1]
                   - 3.0 * con[2] * con[1])
        dmu[1] += -((dxxx * a2 - 3.0 * con[0] * con[1]
                     + 3.0 * a1 * a1 * con[1]) * dG[0]
                    + (dxxy * a2 + dxxy_dy) * (dG[1] + dG[2] + dG[4])
                    + (dxyy * a2 + dxyy_dy) * (dG[3] + dG[5] + dG[6])
                    + (dyyy * a2 - 3.0 * con[2] ** 2
                       + 3.0 * a2 * a2 * con[2]) * dG[7]) * G
        hA = dG[1] + dG[2] + dG[4]   # xxy-class cotangents
        hB = dG[3] + dG[5] + dG[6]   # xyy-class cotangents
        dVxxx_dcxx = (-0.5 * dxxx * X[0] * X[0] + 3.0 * con[0] * X[0]
                      + 3.0 * a1 - 3.0 * a1 * a1 * X[0])
        dVxxy_dcxx = (-0.5 * dxxy * X[0] * X[0] + 2.0 * con[1] * X[0]
                      - 2.0 * a1 * a2 * X[0] + a2)
        dVxyy_dcxx = (-0.5 * dxyy * X[0] * X[0] - a2 * a2 * X[0]
                      + con[2] * X[0])
        dVyyy_dcxx = -0.5 * dyyy * X[0] * X[0]
        dVxxx_dcxy = (-dxxx * X[0] * X[1] + 3.0 * con[0] * X[1]
                      - 3.0 * a1 * a1 * X[1])
        dVxxy_dcxy = (-dxxy * X[0] * X[1] + 2.0 * con[1] * X[1] + 2.0 * a1
                      - 2.0 * a1 * a2 * X[1] - a1 * a1 * X[0]
                      + con[0] * X[0])
        dVxyy_dcxy = (-dxyy * X[0] * X[1] + 2.0 * con[1] * X[0] + 2.0 * a2
                      - a2 * a2 * X[1] - 2.0 * a1 * a2 * X[0]
                      + con[2] * X[1])
        dVyyy_dcxy = (-dyyy * X[0] * X[1] + 3.0 * con[2] * X[0]
                      - 3.0 * a2 * a2 * X[0])
        dVxxx_dcyy = -0.5 * dxxx * X[1] * X[1]
        dVxxy_dcyy = (-0.5 * dxxy * X[1] * X[1] - a1 * a1 * X[1]
                      + con[0] * X[1])
        dVxyy_dcyy = (-0.5 * dxyy * X[1] * X[1] + 2.0 * con[1] * X[1]
                      - 2.0 * a1 * a2 * X[1] + a1)
        dVyyy_dcyy = (-0.5 * dyyy * X[1] * X[1] + 3.0 * con[2] * X[1]
                      + 3.0 * a2 - 3.0 * a2 * a2 * X[1])
        dcon[0] += (dVxxx_dcxx * dG[0] + dVxxy_dcxx * hA
                    + dVxyy_dcxx * hB + dVyyy_dcxx * dG[7]) * G
        dcon[1] += (dVxxx_dcxy * dG[0] + dVxxy_dcxy * hA
                    + dVxyy_dcxy * hB + dVyyy_dcxy * dG[7]) * G
        dcon[2] += (dVxxx_dcyy * dG[0] + dVxxy_dcyy * hA
                    + dVxyy_dcyy * hB + dVyyy_dcyy * dG[7]) * G


_REPLICAS = {
    "value": _bwd_value,
    "derivative": _bwd_derivative,
    "laplacian": _bwd_laplacian,
    "third": _bwd_third,
}


def replica_backward(order, means, values, conics, samples, cotangent, mask):
    """Loop the reference per-pair form over the binning's pairs.

    ``cotangent`` has the reference's full row-major component layout
    (N, D^k, C); ``mask`` is the (N, P) pair-inclusion mask of the binning.
    Accumulation is fp64 (the summation-order analogue of CUDA's atomics is
    not reproducible; fp64 removes it from the comparison).
    """
    N, D = samples.shape
    P, C = values.shape
    fn = _REPLICAS[order]
    means = means.astype(np.float64)
    values = values.astype(np.float64)
    conics = conics.astype(np.float64)
    samples = samples.astype(np.float64)
    cot = cotangent.astype(np.float64)
    dmu = np.zeros((P, D))
    dval = np.zeros((P, C))
    dcon = np.zeros((P, conics.shape[1]))
    for n in range(N):
        g = cot[n]
        for p in range(P):
            if not mask[n, p]:
                continue
            X = _wrap(means[p] - samples[n])
            fn(X, conics[p], values[p], g, dmu[p], dval[p], dcon[p], D)
    return dmu, dval, dcon


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("order", ["value", "derivative", "laplacian",
                                   "third"])
def test_tiled_grads_match_backward_cu_replica(rng, D, order):
    P, N, C = 23, 31, 3
    means, values, covs, conics = make_gaussians(rng, P, D, C)
    samples = make_samples(rng, N, D)
    m, v, c, s = map(jnp.asarray, (means, values, conics, samples))
    cfg = SamplerConfig(max_tiles_per_gaussian=8).with_dims(D)

    state = binning.build(cfg, m, jnp.asarray(covs), s)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    fg = binning.forward_geometry(state, 128, 128)
    bg = binning.backward_geometry(state, 128, 64)
    mask = np.asarray(binning.pair_mask_dense(cfg, state, s, P))

    k = D ** {"value": 0, "derivative": 1, "laplacian": 2, "third": 3}[order]
    cot = rng.normal(0.0, 1.0, (N, k, C)).astype(np.float32)

    def f(m_, v_, c_):
        (out,) = sampling.sample_tiled_multi(
            (order,), cfg, m_, v_, c_, s, state, fg, bg,
            block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128,
        )
        return out.reshape(N, k, C)

    _, vjp = jax.vjp(f, m, v, c)
    got = vjp(jnp.asarray(cot))

    want = replica_backward(order, means, values, conics, samples, cot, mask)
    for g_got, g_want, name in zip(got, (want[0], want[1], want[2]),
                                   ("means", "values", "conics")):
        np.testing.assert_allclose(
            np.asarray(g_got), g_want, rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(g_want).max())),
            err_msg=f"dL_d{name} ({order}, D={D})",
        )


def test_reference_third_d1_dconic_is_wrong():
    """Pin the documented reference defect: backward.cu:322-325's D=1 third
    dV_dc does NOT equal the finite-difference derivative of its own forward
    (forward.cu:239-247: w = G * (3 c x1 - x1^3)), while the corrected form
    used by the replica and ops/formulas.py does."""
    X, c = 0.37, 2.1

    def w(c_):
        x1 = c_ * X
        return np.exp(-0.5 * c_ * X * X) * (3.0 * c_ * x1 - x1 ** 3)

    eps = 1e-6
    fd = (w(c + eps) - w(c - eps)) / (2 * eps)
    x1 = c * X
    G = np.exp(-0.5 * c * X * X)
    ref_form = (2.0 * X * X - 2.0 * x1 * x1 * X
                - 0.5 * (2.0 * X * x1 - X) * X * X
                + 0.5 * (x1 * x1 - c) * x1 * X * X) * G
    p = 3.0 * c * x1 - x1 ** 3
    ours = (-0.5 * X * X * p + 6.0 * x1 - 3.0 * x1 * x1 * X) * G
    np.testing.assert_allclose(ours, fd, rtol=1e-5)
    assert abs(ref_form - fd) > 1.0  # the reference form is not a derivative
