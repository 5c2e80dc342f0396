"""Computed speed-of-light model for the sampling step (SURVEY.md §5:
"per-op roofline calc vs speed-of-light").

The step's irreducible work is the same-tile (entry, sample) pair sweep:
``pair_count`` computes the EXACT pair total sum_t E_t * S_t from the
binning structure, and ``step_roofline`` turns it into a lower-bound step
time on the device:

  t_sol = max(fp32 flops / PEAK fp32, HBM bytes / PEAK bandwidth)

The pair kernels (kernels/tiled.py) are fp32 FMA chains and reductions
outside the tensor cores, so the fp32 (non-tensor) rate is the compute
peak.  The per-pair operation counts are hand-derived from ops/formulas.py
(commented per term below).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import tri_size
from ..ops import formulas

# Published peaks per JAX device_kind (dense, no sparsity).  Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part: 67 TFLOP/s fp32 outside the
# tensor cores, 3.35 TB/s HBM3, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; an unknown device is an
    error, not a default."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def pair_count(ent_tile, num_tiles: int, s_tile) -> int:
    """Exact same-tile (entry, sample) pair total sum_t E_t * S_t (the
    reference's hot-loop work, forward.cu:104-144)."""
    ent_tile = np.asarray(ent_tile).reshape(-1)
    s_tile = np.asarray(s_tile).reshape(-1)
    e_t = np.bincount(ent_tile[ent_tile < num_tiles],
                      minlength=num_tiles)
    s_t = np.bincount(s_tile[s_tile < num_tiles], minlength=num_tiles)
    return int((e_t.astype(np.int64) * s_t.astype(np.int64)).sum())


def pair_flops(orders: Sequence[str], D: int, C: int) -> float:
    """fp32 flops per pair, forward + backward, hand-derived from the pair
    math the kernels run (an FMA counts 2):

    shared, both passes: X (D sub, + wrap ~4 D), a = C X (2 D^2),
      power (2 D + 1), exp (~8), PSD + tile mask (~3);
    forward: K component weights (~4 per weight on average) and K*C
      value FMAs + reduction adds (4 K C);
    backward: the same weights, h = sum_c g v (2 C per component), dvalues
      (4 K C), and the fused VJP (formulas.vjp_params_fused: S0/W
      accumulators ~4 K, dmu 2 D^2, dcon ~6 tri) + reductions (D + tri).
    """
    tri = tri_size(D)
    K = sum(formulas.n_unique(o, D) for o in orders)
    shared = D + 4 * D + 2 * D * D + 2 * D + 1 + 8 + 3
    fwd = shared + 4 * K + 4 * K * C
    bwd = (shared + 4 * K + 2 * C * K + 4 * K * C + 4 * K + 2 * D * D
           + 6 * tri + 2 * (D + tri))
    return float(fwd + bwd)


def step_roofline(orders: Sequence[str], D: int, C: int, pairs: int,
                  N: int, E: int, device_kind: str) -> dict:
    """Speed-of-light step time for one fused fwd+bwd step on
    ``device_kind``.  Bytes are the kernels' minimum traffic: sample
    coordinates + tile (read by both passes), the K*C output rows (written
    forward, read backward as the cotangent), the entry parameter rows
    (read both passes) and the per-entry gradient rows (written)."""
    pk = peaks(device_kind)
    K = sum(formulas.n_unique(o, D) for o in orders)
    nparam = D + tri_size(D) + C
    flops = pairs * pair_flops(orders, D, C)
    bytes_ = 4 * (2 * N * (D + 1) + 2 * N * K * C + 2 * E * (nparam + 1)
                  + E * nparam)
    t_flops = flops / pk["fp32_flops"]
    t_bytes = bytes_ / pk["hbm_bytes_s"]
    return {
        "pairs": pairs,
        "flops": flops,
        "bytes": bytes_,
        "sol_step_s": max(t_flops, t_bytes),
        "bound": "fp32" if t_flops >= t_bytes else "hbm",
    }
