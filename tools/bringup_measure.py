"""Bring-up measurements on one GPU, one JSON line per result.

  blocks    pair-kernel block sizes: the forward and the backward kernel
            alone at 100k Gaussians x 1M samples, D=2, three orders, C=4.
  profile   device time per kernel of the fused fwd+bwd step at that
            point (tiled, D=2) and at D=3 (chunked).
  dense     the all-pairs XLA path, P=4096 x N=65,536, fwd+bwd.
  dynamics  a dynamics training step at P=100k, chunked aggregation sweeps
            vs the neighbor-table ("grid") path.

    python tools/bringup_measure.py [phase ...]   # default: all
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import bench
from dgs.kernels import tiled

ORD3 = ("value", "derivative", "laplacian")


def out(kind, **kw):
    print(json.dumps({"result": kind, **kw}), flush=True)


def _time(fn, *args, repeats=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def phase_blocks():
    from dgs.binning import grid as binning
    from dgs.config import SamplerConfig
    from dgs.models.field import init_field

    P, N, D, C = 100_000, 1_000_000, 2, 4
    field = init_field(jax.random.PRNGKey(0), P, D, C, sigma=2.0 / P ** 0.5)
    samples = jax.random.uniform(jax.random.PRNGKey(1), (N, D),
                                 minval=-1.0, maxval=1.0)
    cfg = SamplerConfig(tile_size=bench.default_tile(P, D), eig_floor=1e-12,
                        axis_radii=True, max_tiles_per_gaussian=3,
                        entry_capacity_factor=8.0)
    state = jax.jit(binning.build, static_argnums=0)(
        cfg, field.means, field.covariances(), samples)
    out("blocks_setup", overflow=int(state.overflow),
        entry_overflow=int(state.entry_overflow),
        entries=int(state.num_entries))
    K = tiled.total_unique(ORD3, D)
    for bn, be, nw in [(32, 32, 4), (32, 32, 2), (16, 32, 2), (32, 16, 2),
                       (16, 16, 1), (64, 16, 2)]:
        smp = tiled.prepare_samples(state, bn)
        ent = jax.jit(lambda m, v, c: tiled.prepare_entries(
            state, m, v, c, be, cfg))(field.means, field.values,
                                      field.conics())
        sweep = binning.forward_geometry(state, bn, be)
        NB = smp[0].shape[1] // bn
        sweep = tuple(tiled.pad_axis(x, 0, NB) for x in sweep)
        f = jax.jit(lambda sw, e, s: tiled.tiled_forward(
            ORD3, 2.0, D, C, sw, e, s, block_n=bn, block_e=be,
            num_warps=nw))
        tf = _time(f, sweep, ent, smp)
        bsweep = binning.backward_geometry(state, be, bn)
        EB = ent[2].shape[1] // be
        bsweep = tuple(tiled.pad_axis(x, 0, EB) for x in bsweep)
        g = jnp.ones((K * C, smp[0].shape[1]), jnp.float32)
        b = jax.jit(lambda sw, e, s, g: tiled.tiled_backward(
            ORD3, 2.0, D, C, sw, e, s, g, block_n=bn, block_e=be,
            num_warps=nw))
        tb = _time(b, bsweep, ent, smp, g)
        out("blocks", block_n=bn, block_e=be, num_warps=nw,
            fwd_s=sorted(tf)[2], bwd_s=sorted(tb)[2], fwd_runs=tf,
            bwd_runs=tb)


def phase_profile():
    """Where the headline steps' device time goes: a profiler trace of one
    run of 3 steps (D=2 tiled, D=3 chunked), reduced per kernel."""
    from dgs.utils import profiling

    for D, method in ((2, "tiled"), (3, "chunked")):
        run, field, samples, sb, cfg = bench.build_step(
            100_000, 1_000_000, D, 4, ORD3, method)
        times, _ = bench.time_run(run, field, samples, sb, 3, repeats=2)
        d = os.path.join("chiprun_out", f"trace_d{D}")
        with profiling.trace(d):
            jax.block_until_ready(run(field, samples, sb, 3))
        rows = profiling.device_op_times(d, top=12, steps=3)
        out("profile", D=D, method=method, step_s=times,
            top=[{k: r[k] for k in ("name", "ms_per_step", "calls")}
                 for r in rows])


def phase_dense():
    from dgs.models.field import init_field
    from dgs.ops import sampling

    P, N, D, C = 4096, 65_536, 2, 4
    f = init_field(jax.random.PRNGKey(0), P, D, C, sigma=0.05)
    x = jax.random.uniform(jax.random.PRNGKey(1), (N, D), minval=-1.0,
                           maxval=1.0)

    @jax.jit
    def step(m, v, c):
        def loss(m, v, c):
            outs = sampling.sample_dense_multi(ORD3, 2.0, m, v, c, x)
            return sum(jnp.sum(o * o) for o in outs)
        return jax.grad(loss, argnums=(0, 1, 2))(m, v, c)

    ts = _time(step, f.means, f.values, f.conics())
    out("dense", P=P, N=N, D=D, C=C, orders=ORD3, step_s=sorted(ts)[2],
        runs=ts)


def phase_dynamics():
    from dgs.config import SamplerConfig
    from dgs.models import dynamics

    P = 100_000
    cfg = SamplerConfig(eig_floor=1e-12, axis_radii=True, ellip_cull=True)
    for method in ("pallas", "grid"):
        _, hist = dynamics.train(
            cfg, P=P, D=2, steps=15, rollout=2, sigma=3.0 * 2.0 / P ** 0.5,
            n_eval=65_536, method=method, eval_method="tiled", log_every=5,
            ladder_frequencies=True, scan_chunk=5, neighbor_capacity=None)
        out("dynamics", method=method, P=P,
            step_s=[h["t_step_s"] for h in hist[1:]],
            nbr_overflow=hist[-1]["nbr_overflow"],
            eval_overflow=hist[-1]["eval_overflow"],
            loss=[h["loss"] for h in hist])


def main():
    from dgs.utils.cache import enable_compile_cache

    enable_compile_cache()
    out("device", device=bench.device_info())
    phases = sys.argv[1:] or ["blocks", "profile", "dynamics", "dense"]
    for p in phases:
        globals()["phase_" + p]()


if __name__ == "__main__":
    main()
