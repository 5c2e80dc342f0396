"""ctypes bindings for the native host runtime (csrc/host_binning.cpp).

Compiled on demand with g++ (no pybind11 in this image; plain C ABI).  The
planner replaces trial-and-error capacity picking: it returns the exact entry
counts, per-axis duplicate extents, and sweep work-block requirements for a
dataset, so SamplerConfig capacities can be set tightly before tracing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_lib_failed = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "host_binning.cpp")
_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "csrc", ".build",
                    "host_binning.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            src = os.path.abspath(_SRC)
            out = os.path.abspath(_OUT)
            if (not os.path.exists(out)
                    or os.path.getmtime(out) < os.path.getmtime(src)):
                os.makedirs(os.path.dirname(out), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", out, src],
                    check=True, capture_output=True,
                )
            lib = ctypes.CDLL(out)
            lib.dgs_plan_capacities.restype = ctypes.c_int
            lib.dgs_max_collisions.restype = ctypes.c_int64
            _lib = lib
        except Exception as e:  # toolchain missing -> numpy fallback
            print(f"dgs.native: build failed ({e}); using numpy fallback",
                  file=sys.stderr)
            _lib_failed = True
        return _lib


def plan_capacities(cfg, means, covariances, samples) -> dict:
    """Capacity plan for the tiled pipeline on this dataset.

    Returns dict with: entries, max_extent (per-axis R), max_tile_entries,
    max_tile_samples, culled, occupied_tiles, and the sweep geometry of the
    pair kernels - work_blocks_fwd/bwd (the longest sweep of any row block,
    i.e. the kernels' largest loop trip count) and work_items_fwd/bwd (the
    summed sweep lengths, each row block counted at least once).  Use it to
    set SamplerConfig.max_tiles_per_gaussian and entry_capacity_factor
    exactly (config_from_plan).
    """
    means = np.ascontiguousarray(np.asarray(means), np.float32)
    covs = np.ascontiguousarray(np.asarray(covariances), np.float32)
    smps = np.ascontiguousarray(np.asarray(samples), np.float32)
    P, D = means.shape
    N = smps.shape[0]
    cfg = cfg.with_dims(D)
    lower = list(cfg.lower) + [0.0] * (3 - D)
    bn, be = cfg.block_n, cfg.block_p
    bbn, bbe = cfg.bwd_blocks

    # Compact-support certificate for the unwrapped (no per-pair torus wrap)
    # kernels: every binned pair satisfies |mu' - x| < period/2 per axis iff
    # max_radius + tile_size < period/2 (SamplerConfig.unwrapped_kernels).
    safe_unwrapped = False
    if cfg.period is not None:
        from ..oracle.dense import radii as compute_radii

        rmax = float(np.asarray(
            compute_radii(covs, D, cfg.radius_sigma, cfg.eig_floor)
        ).max(initial=0.0))
        safe_unwrapped = (rmax + cfg.tile_size) < cfg.period / 2.0

    lib = _load()
    if lib is not None:
        out = (ctypes.c_int64 * 10)()
        extents = ([cfg.period] * 3 if cfg.period is not None
                   else [u - l for l, u in zip(cfg.lower, cfg.upper)] +
                   [0.0] * (3 - D))
        rc = lib.dgs_plan_capacities(
            means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            covs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            smps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(P), ctypes.c_int64(N), ctypes.c_int32(D),
            ctypes.c_double(lower[0]), ctypes.c_double(lower[1]),
            ctypes.c_double(lower[2]),
            # Per-axis world extents (anisotropic open boxes); wrap behavior
            # is the separate flag.
            ctypes.c_double(extents[0]), ctypes.c_double(extents[1]),
            ctypes.c_double(extents[2]),
            ctypes.c_double(cfg.tile_size),
            ctypes.c_int32(1 if cfg.period is not None else 0),
            ctypes.c_double(cfg.radius_sigma), ctypes.c_double(cfg.eig_floor),
            ctypes.c_int32(bn), ctypes.c_int32(be),
            ctypes.c_int32(bbe), ctypes.c_int32(bbn),
            ctypes.c_int32(1 if cfg.axis_radii else 0),
            ctypes.c_int32(1 if cfg.ellip_cull else 0),
            out,
        )
        if rc == 0:
            vals = list(out)
            return {
                "entries": vals[0],
                "max_extent": vals[1],
                "max_tile_entries": vals[2],
                "max_tile_samples": vals[3],
                "work_blocks_fwd": vals[4],
                "work_blocks_bwd": vals[5],
                "culled": vals[6],
                "occupied_tiles": vals[7],
                "work_items_fwd": vals[8],
                "work_items_bwd": vals[9],
                "safe_unwrapped": safe_unwrapped,
            }
    plan = _plan_capacities_numpy(cfg, means, covs, smps, bn, be, bbn, bbe)
    plan["safe_unwrapped"] = safe_unwrapped
    return plan


def _plan_capacities_numpy(cfg, means, covs, smps, bn, be, bbn, bbe) -> dict:
    """Pure-numpy fallback with identical semantics (slower)."""
    import dataclasses

    import jax.numpy as jnp

    from ..binning import grid as binning

    # Count with an untruncated entry list - the PLAN must report true
    # totals, not totals clipped to the (yet-to-be-planned) capacity.
    R = cfg.max_tiles_per_gaussian
    cfg = dataclasses.replace(cfg, entry_capacity_factor=float(R ** cfg.D))
    state = binning.build(cfg, means, covs, smps)
    ent_tile = np.asarray(state.ent_tile[0])
    T = binning.num_tiles(cfg, means.shape[1])
    valid = ent_tile < T
    # The sweep geometry must reflect the planned (compact) entry list,
    # not the untruncated sentinel tail: slice it to the valid entries
    # rounded up one block, like the runtime capacity will be.
    n_valid = int(valid.sum())
    e_keep = max(-(-max(n_valid, 1) // bbe) * bbe, bbe)
    state = state._replace(
        ent_tile=state.ent_tile[:, :e_keep],
        ent_gid=state.ent_gid[:e_keep],
        ent_start=jnp.minimum(state.ent_start, e_keep),
    )
    fb, fn = binning.forward_geometry(state, bn, be)
    bb, bnn = binning.backward_geometry(state, bbe, bbn)
    tiles, counts = np.unique(ent_tile[valid], return_counts=True)
    s_t = np.asarray(binning.sample_tiles(cfg, smps))
    _, s_counts = np.unique(s_t, return_counts=True)
    rad = np.asarray(state.radii)
    lo, hi = binning.gaussian_rects(cfg, means, state.radii)
    ext = np.asarray(hi - lo)
    fn_np, bn_np = np.asarray(fn), np.asarray(bnn)
    return {
        "entries": int(valid.sum()),
        "max_extent": int(ext.max(initial=0)),
        "max_tile_entries": int(counts.max(initial=0)),
        "max_tile_samples": int(s_counts.max(initial=0)),
        "work_blocks_fwd": int(fn_np.max(initial=0)),
        "work_blocks_bwd": int(bn_np.max(initial=0)),
        "culled": int((rad <= 0).all(axis=-1).sum() if rad.ndim == 2
                      else (rad <= 0).sum()),
        "occupied_tiles": int(len(tiles)),
        "work_items_fwd": int(np.maximum(fn_np, 1).sum()),
        "work_items_bwd": int(np.maximum(bn_np, 1).sum()),
    }


def config_from_plan(cfg, plan: dict, P: int) -> "SamplerConfig":
    """Tight SamplerConfig from a capacity plan: max_tiles_per_gaussian,
    entry_capacity_factor, and the compact-support certificate of the
    wrap-free kernels."""
    import dataclasses

    R = max(int(plan["max_extent"]), 1)
    # The planner bins in f64 while the device bins in f32, so borderline
    # 3-sigma tiles can differ by a few entries: keep a small margin.
    factor = plan["entries"] / max(P, 1) + 0.05
    return dataclasses.replace(
        cfg, max_tiles_per_gaussian=R, entry_capacity_factor=factor,
        unwrapped_kernels=bool(plan.get("safe_unwrapped", False)),
    )


def max_collisions(cfg, means, radii) -> int:
    """Worst-case neighbor-candidate count (aggregation capacity planner)."""
    means = np.ascontiguousarray(np.asarray(means), np.float32)
    rad = np.ascontiguousarray(np.asarray(radii), np.float32)
    P, D = means.shape
    lib = _load()
    if lib is not None:
        return int(lib.dgs_max_collisions(
            means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rad.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(P), ctypes.c_int32(D),
            ctypes.c_double(cfg.period if cfg.period else 0.0),
            ctypes.c_int32(1 if cfg.period is not None else 0),
        ))
    from ..ops.aggregation import suggest_capacity
    import jax.numpy as jnp

    return suggest_capacity(cfg, jnp.asarray(means), jnp.asarray(rad))
