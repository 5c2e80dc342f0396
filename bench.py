"""Headline benchmark: Gaussian point-samples/sec on one GPU, fused fwd+bwd.

BASELINE.json config 3: 100k Gaussians, 1M samples, fused value + derivative
+ Hessian forward/backward through the binned pair kernels, with the
Gaussian side re-binned every step (the reference re-bins every step too -
SURVEY.md 3.5).  D=3 goes through the chunk-packed path.

Prints ONE JSON line with the throughput, the step time, the device
(platform, device_kind, count, and the card's name and power limit from
nvidia-smi) and the overflow counters, which must all be 0.  Needs a GPU:
on any other backend it exits non-zero without a result.

Env overrides: BENCH_P, BENCH_N, BENCH_D, BENCH_C, BENCH_STEPS,
BENCH_METHOD (tiled|chunked), BENCH_TILE, BENCH_ORDERS (comma list).
"""

import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from dgs.config import SamplerConfig
from dgs.models.field import init_field
from dgs.models.pigs import field_outputs
from dgs.utils import native

ORDERS = ("value", "derivative", "laplacian")


def device_info() -> dict:
    """The device the numbers belong to; a run without a GPU stops here."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.stdout.strip()}


def default_tile(P: int, D: int) -> float:
    """Tile edge from the footprint geometry, in footprint radii r = 3 sigma
    (sigma = 2 / P^(1/D)): 2.7 r at D=2 (a few tiles per footprint), 0.8 r
    at D=3, where the candidate pairs per sample grow like (2r + tile)^3
    (at P=100k, N=1M: 2.4e9 same-tile pairs at tile 2.6 r, 5.0e8 at 0.8 r
    with 32x16 chunks)."""
    r = 3.0 * 2.0 / P ** (1.0 / D)
    return (2.7 if D <= 2 else 0.8) * r


def build_step(P: int, N: int, D: int, C: int, orders=ORDERS,
               method: str = "tiled", tile: float = None, seed: int = 0):
    """Field, samples and a jitted ``run(field, samples, sb, n)`` that
    takes ``n`` dependency-chained fused fwd+bwd steps (lax.scan) and
    returns (field, (loss, diagnostics) per step).  Capacities come from
    the host planners on the initial parameters."""
    from dgs.ops import formulas
    from dgs.ops import sampling_chunked

    tile = tile or default_tile(P, D)
    sigma = 2.0 / max(P, 1) ** (1.0 / D)
    field = init_field(jax.random.PRNGKey(seed), P, D, C, sigma=sigma)
    samples = jax.random.uniform(
        jax.random.PRNGKey(seed + 1), (N, D), minval=-1.0, maxval=1.0)
    cfg = SamplerConfig(tile_size=tile, max_tiles_per_gaussian=3,
                        eig_floor=1e-12, axis_radii=True,
                        ellip_cull=D >= 3)
    if method == "chunked":
        cfg, cplan = sampling_chunked.plan_chunked(
            cfg, field.means, field.covariances(), samples)
        sb = sampling_chunked.chunk_samples(cfg, samples, cplan, cfg.block_n)
    else:
        from dgs.binning import grid as binning

        plan = native.plan_capacities(cfg, field.means, field.covariances(),
                                      samples)
        cfg = native.config_from_plan(cfg, plan, P)
        sb = jax.jit(binning.bin_samples, static_argnums=0)(cfg, samples)

    def loss_fn(field, samples, sb):
        # Sum of squares over the FULL symmetric tensors, from the unique
        # components weighted by their mirror multiplicities, on the
        # kernels' padded tile-sorted layout (pad columns are zero).
        if method == "chunked":
            outs, diag = sampling_chunked.sample_chunked(
                cfg, field.means, field.values, field.conics(),
                field.covariances(), samples, cplan, sb, orders,
                padded_outputs=True)
        else:
            outs, diag = field_outputs(
                cfg, field, samples, orders=orders, method="tiled",
                sorted_outputs=True, unique_outputs=True,
                padded_outputs=True, sample_binning=sb)
        diag = {k: v for k, v in diag.items() if k != "perm"}
        loss = sum(
            jnp.einsum("ucn,u->", o * o, jnp.asarray(
                formulas.sym_multiplicity(order, D), jnp.float32))
            for order, o in outs.items())
        return loss / N, diag

    @functools.partial(jax.jit, static_argnums=(3,))
    def run(field, samples, sb, n):
        def step(field, _):
            (loss, diag), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(field, samples, sb)
            # Dependency-carrying update: each step consumes the previous
            # step's gradients, like an optimizer.
            field = jax.tree.map(lambda p, g: p - 1e-12 * g, field, grads)
            return field, (loss, diag)

        return jax.lax.scan(step, field, None, length=n)

    return run, field, samples, sb, cfg


def time_run(run, field, samples, sb, steps: int, repeats: int = 3):
    """Seconds per step of each of ``repeats`` timed runs of ``steps``
    chained steps, after one warm-up run; every run ends in
    block_until_ready.  Returns (times, (loss, diag) of the last run)."""
    jax.block_until_ready(run(field, samples, sb, steps))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(field, samples, sb, steps)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / steps)
    return times, out[1]


def main():
    from dgs.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = device_info()
    P = int(os.environ.get("BENCH_P", 100_000))
    N = int(os.environ.get("BENCH_N", 1_000_000))
    D = int(os.environ.get("BENCH_D", 2))
    C = int(os.environ.get("BENCH_C", 4))
    steps = int(os.environ.get("BENCH_STEPS", 10))
    method = os.environ.get("BENCH_METHOD", "chunked" if D == 3 else "tiled")
    orders = tuple(os.environ.get("BENCH_ORDERS", ",".join(ORDERS)).split(","))
    tile = float(os.environ.get("BENCH_TILE", default_tile(P, D)))

    run, field, samples, sb, cfg = build_step(P, N, D, C, orders, method,
                                              tile)
    times, (loss, diag) = time_run(run, field, samples, sb, steps)
    overflow = {k: int(v[-1]) for k, v in diag.items()}
    dt = sorted(times)[len(times) // 2]
    print(json.dumps({
        "metric": "gaussian_point_samples_per_sec_fwd_bwd",
        "value": N / dt,
        "unit": "samples/s",
        "step_s": dt, "step_s_runs": times,
        "P": P, "N": N, "D": D, "C": C, "orders": orders,
        "method": method, "tile": cfg.tile_size,
        "blocks": [cfg.block_n, cfg.block_p, *cfg.bwd_blocks],
        "loss_finite": bool(jnp.isfinite(loss[-1])),
        "overflow": overflow, "device": dev,
    }))
    if any(overflow.values()):
        sys.exit(f"overflow diagnostics {overflow}")


if __name__ == "__main__":
    main()
