"""Smoke test of the main path on one GPU (or, with --four-cards, of the
sharded config-5 steps on four).

    python chip_smoke.py               # one card, every default phase
    python chip_smoke.py --four-cards  # only the 4-card sharded steps

Default phases, each of which must pass:
  1. device      JAX runs on a GPU; the card's name and power limit.
  2. parity      the compiled pair kernels against the masked dense oracle
                 at P=100k: D=2 tiled path (three orders) and D=3 chunked
                 path (four orders), values and gradients of means, conics
                 and values, on a 16,384-sample subset.
  3. headline    100k Gaussians x 1M samples, D=2, three orders, fused
                 fwd+bwd with per-step re-binning (bench.py's step).
  4. pigs        pigs.train at BASELINE config 4 (P=100k, 262,144
                 collocation points), a few steps: loss finite and falling.
  5. dynamics    dynamics.train at P=100k through the chunked aggregation.
  6. gpu tests   the tests marked ``gpu``, run in this process.

Every overflow counter must be 0.  The last line of standard output is one
JSON object, {"ok": true, "device": {...}}; nothing is printed there on
failure, and the exit code is non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ORD3 = ("value", "derivative", "laplacian")
ORD4 = ORD3 + ("third",)
ORACLE_BLOCK = 512

# Problem sizes of the phases (BASELINE.json configs 3-5).
SIZES = dict(
    P=100_000,            # Gaussians: parity, headline, PIGS, dynamics
    N=1_000_000,          # headline samples
    parity_samples=16_384,
    collocation=262_144,  # PIGS config 4
    n_eval=65_536,        # dynamics eval points
    P5=1_000_000,         # config 5 (--four-cards)
    N5=16_777_216,
)

# Tolerances of the parity phase, as max|kernel - oracle| / max|oracle| per
# output or gradient.  Both sides are fp32 with no TF32 (the kernels use
# FMA chains only; the oracle pins Precision.HIGHEST); they differ in sum
# order - per entry block in the kernel, one einsum in the oracle, and the
# gradients' segment sums run as atomics here - so a few hundred fp32 terms
# per output give ~1e-6 relative error and up to ~1e4 samples per gradient
# row ~1e-5.  TF32 anywhere would show as ~1e-3.
TOL_VALUES = 1e-4
TOL_GRADS = 1e-4


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def phase_device(n_cards: int):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    log("device", platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs), backend=jax.default_backend())


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _oracle_vjp(orders, cover, s_tile, means, values, conics, samples,
                cots, period):
    """Masked dense oracle outputs and their VJP, in sample blocks.
    ``cover`` (T+1, P+1) says which (tile, gaussian) pairs the binning
    formed; a sample of tile t meets exactly the Gaussians of cover[t]."""
    from dgs.oracle import dense as oracle

    P = means.shape[0]

    @jax.jit
    def block(m, v, c, s, st, gs):
        mask = cover[st][:, :P]

        def f(m, v, c):
            return [oracle.evaluate(o, m, v, c, s, period=period,
                                    pair_mask=mask) for o in orders]

        outs, vjp = jax.vjp(f, m, v, c)
        return outs, vjp(list(gs))

    outs = [[] for _ in orders]
    grads = None
    for a in range(0, samples.shape[0], ORACLE_BLOCK):
        sl = slice(a, a + ORACLE_BLOCK)
        o, g = block(means, values, conics, samples[sl], s_tile[sl],
                     [c[sl] for c in cots])
        for k in range(len(orders)):
            outs[k].append(o[k])
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return [jnp.concatenate(x) for x in outs], grads


def _check(name, orders, outs, grads, ref_outs, ref_grads):
    errs = {o: _rel_err(a, b) for o, a, b in zip(orders, outs, ref_outs)}
    gerrs = {n: _rel_err(a, b) for n, a, b in
             zip(("means", "values", "conics"), grads, ref_grads)}
    log(name, value_rel_err=errs, grad_rel_err=gerrs,
        tol_values=TOL_VALUES, tol_grads=TOL_GRADS)
    bad = ({o: e for o, e in errs.items() if not e <= TOL_VALUES}
           | {n: e for n, e in gerrs.items() if not e <= TOL_GRADS})
    if bad:
        raise AssertionError(f"{name}: beyond tolerance {bad}")


def phase_parity():
    import bench
    from dgs.binning import grid as binning
    from dgs.models.field import init_field
    from dgs.ops import sampling, sampling_chunked
    from dgs.utils import native

    P, D, NS = SIZES["P"], 2, SIZES["parity_samples"]
    field = init_field(jax.random.PRNGKey(0), P, D, 4,
                       sigma=2.0 / P ** 0.5)
    samples = jax.random.uniform(jax.random.PRNGKey(1), (NS, D),
                                 minval=-1.0, maxval=1.0)
    m, v, c, cov = field.means, field.values, field.conics(), \
        field.covariances()
    from dgs.config import SamplerConfig

    cfg = SamplerConfig(tile_size=bench.default_tile(P, D),
                        eig_floor=1e-12, axis_radii=True, ellip_cull=True)
    cfg = native.config_from_plan(
        cfg, native.plan_capacities(cfg, m, cov, samples), P)

    def tiled(m, v, c):
        outs, diag = sampling.sample_binned(cfg, m, v, c, cov, samples, ORD3)
        return [outs[o] for o in ORD3], diag

    (outs, vjp, diag) = jax.vjp(tiled, m, v, c, has_aux=True)
    assert all(int(x) == 0 for k, x in diag.items() if k != "perm"), diag
    key = jax.random.PRNGKey(2)
    cots = [jax.random.normal(jax.random.fold_in(key, i), o.shape)
            for i, o in enumerate(outs)]
    grads = vjp(cots)
    grads2 = vjp(cots)
    deterministic = all(bool(jnp.all(a == b)) for a, b in zip(grads, grads2))

    state = binning.build(cfg, m, cov, samples)
    T = binning.num_tiles(cfg, D)
    cover = jnp.zeros((T + 1, P + 1), bool).at[
        jnp.minimum(state.ent_tile[0], T), state.ent_gid].set(True)
    s_tile = binning.sample_tiles(cfg, samples)
    ref_outs, ref_grads = _oracle_vjp(ORD3, cover, s_tile, m, v, c, samples,
                                      cots, cfg.period)
    _check("parity_tiled_d2", ORD3, outs, grads, ref_outs, ref_grads)
    log("parity_tiled_d2_determinism", bitwise_equal_grads=deterministic)

    # D=3 through the chunk-packed path, four orders.
    D = 3
    field = init_field(jax.random.PRNGKey(3), P, D, 1,
                       sigma=2.0 / P ** (1 / 3))
    samples = jax.random.uniform(jax.random.PRNGKey(4), (NS, D),
                                 minval=-1.0, maxval=1.0)
    m, v, c, cov = field.means, field.values, field.conics(), \
        field.covariances()
    cfg = SamplerConfig(tile_size=bench.default_tile(P, D), eig_floor=1e-12,
                        axis_radii=True, ellip_cull=True)
    cfg, plan = sampling_chunked.plan_chunked(cfg, m, cov, samples)
    cs = sampling_chunked.chunk_samples(cfg, samples, plan, cfg.block_n)

    def chunked(m, v, c):
        outs, diag = sampling_chunked.sample_chunked(
            cfg, m, v, c, cov, samples, plan, cs, ORD4)
        return [outs[o] for o in ORD4], diag

    (outs, vjp, diag) = jax.vjp(chunked, m, v, c, has_aux=True)
    assert all(int(x) == 0 for k, x in diag.items() if k != "perm"), diag
    cots = [jax.random.normal(jax.random.fold_in(key, i), o.shape)
            for i, o in enumerate(outs)]
    grads = vjp(cots)
    # The pairs the chunked path formed: its own duplicate_entries call
    # (same rect cap, radii and ellipsoid-cull conics).
    from dgs.oracle.dense import radii, radii_axis

    rad = (radii_axis if cfg.axis_radii else radii)(
        cov, D, cfg.radius_sigma, cfg.eig_floor)
    gid, tile, *_ = binning.duplicate_entries(
        cfg, m, rad, plan.rect, min(P * plan.rect ** D, plan.entries),
        conics=c)
    T = binning.num_tiles(cfg, D)
    cover = jnp.zeros((T + 1, P + 1), bool).at[
        jnp.minimum(tile, T), gid].set(True)
    s_tile = binning.sample_tiles(cfg, samples)
    ref_outs, ref_grads = _oracle_vjp(ORD4, cover, s_tile, m, v, c, samples,
                                      cots, cfg.period)
    _check("parity_chunked_d3", ORD4, outs, grads, ref_outs, ref_grads)


def phase_headline():
    import bench

    P, N = SIZES["P"], SIZES["N"]
    run, field, samples, sb, cfg = bench.build_step(P, N, 2, 4, ORD3, "tiled")
    t0 = time.perf_counter()
    field2, (loss, diag) = jax.block_until_ready(run(field, samples, sb, 3))
    compile_and_run_s = time.perf_counter() - t0
    times, (loss, diag) = bench.time_run(run, field, samples, sb, 3,
                                         repeats=1)
    overflow = {k: int(jnp.max(x)) for k, x in diag.items()}
    finite = bool(jnp.all(jnp.isfinite(loss))) and all(
        bool(jnp.all(jnp.isfinite(x))) for x in jax.tree.leaves(field2))
    log("headline", P=P, N=N, D=2, C=4, orders=ORD3,
        step_s=times[0], first_call_s=compile_and_run_s,
        overflow=overflow, finite=finite)
    assert finite and not any(overflow.values()), (finite, overflow)


def phase_pigs():
    from dgs.config import SamplerConfig
    from dgs.models import pigs

    P, n_col = SIZES["P"], SIZES["collocation"]
    cfg = SamplerConfig(tile_size=0.051, eig_floor=1e-12, axis_radii=True,
                        ellip_cull=True)
    t0 = time.perf_counter()
    _, hist = pigs.train(cfg, P=P, D=2, C=1, steps=20,
                         n_collocation=n_col, learning_rate=2e-3,
                         sigma=2.0 / P ** 0.5, method="tiled", log_every=5,
                         scan_chunk=5)
    losses = [h["loss"] for h in hist]
    overflow = {k: hist[-1][k] for k in ("bin_overflow", "entry_overflow")}
    log("pigs", P=P, steps=20, n_collocation=n_col, losses=losses,
        step_s=min(h["t_step_s"] for h in hist[1:]), overflow=overflow,
        wall_s=time.perf_counter() - t0)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert not any(overflow.values()), overflow


def phase_dynamics():
    from dgs.config import SamplerConfig
    from dgs.models import dynamics

    P = SIZES["P"]
    cfg = SamplerConfig(eig_floor=1e-12, axis_radii=True, ellip_cull=True)
    t0 = time.perf_counter()
    _, hist = dynamics.train(
        cfg, P=P, D=2, steps=10, rollout=2, sigma=3.0 * 2.0 / P ** 0.5,
        n_eval=SIZES["n_eval"], method="pallas", eval_method="tiled",
        log_every=5, ladder_frequencies=True, scan_chunk=5)
    losses = [h["loss"] for h in hist]
    log("dynamics", P=P, steps=10, losses=losses,
        step_s=min(h["t_step_s"] for h in hist[1:]),
        nbr_overflow=hist[-1]["nbr_overflow"],
        eval_overflow=hist[-1]["eval_overflow"],
        wall_s=time.perf_counter() - t0)
    assert all(np.isfinite(losses)), losses
    assert hist[-1]["nbr_overflow"] == 0 and hist[-1]["eval_overflow"] == 0


def phase_gpu_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    log("gpu_tests", pytest_exit_code=int(rc))
    assert rc == 0, f"gpu tests failed (pytest exit code {rc})"


def phase_four_cards():
    """BASELINE config 5 (1M Gaussians x 16M samples, D=2) through the
    sample-sharded step on a (4, 1) mesh and the Gaussian-sharded step on
    a (1, 4) mesh, each against the same step computed on one card."""
    import optax

    from dgs.config import SamplerConfig
    from dgs.models import pigs
    from dgs.models.field import init_field
    from dgs.parallel import mesh as pmesh
    from dgs.utils import native

    P, N, D = SIZES["P5"], SIZES["N5"], 2
    devs = jax.devices()[:4]
    sigma = 2.0 / P ** 0.5
    u_star, f_rhs = pigs.manufactured_solution(D)
    field = init_field(jax.random.PRNGKey(0), P, D, 1, sigma=sigma)
    cfg = SamplerConfig(tile_size=2.7 * 3.0 * sigma, eig_floor=1e-12,
                        axis_radii=True, ellip_cull=True)
    probe = jax.random.uniform(jax.random.PRNGKey(9), (N // 4, D),
                               minval=-1.0, maxval=1.0)
    cfg = native.config_from_plan(
        cfg, native.plan_capacities(cfg, field.means, field.covariances(),
                                    probe), P)
    import dataclasses

    # Headroom for collocation points other than the probe's.
    cfg = dataclasses.replace(
        cfg, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian + 1,
        entry_capacity_factor=cfg.entry_capacity_factor * 1.5 + 1.0,
        unwrapped_kernels=False)
    # An "optimizer" that leaves the parameters alone and keeps the step's
    # gradients in its state, so they can be compared directly.
    opt = optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g),
                                       {"g": g}))
    key = jax.random.PRNGKey(1)

    def one_card_loss(field, colloc_keys, n_local):
        """Mean of pigs_loss over the given per-shard keys, on one card,
        drawing each shard's points exactly as the sharded steps do."""
        def shard_loss(f, k):
            k1, k2 = jax.random.split(k)
            x = jax.random.uniform(k1, (n_local, D), minval=-1.0, maxval=1.0)
            dx = jax.random.uniform(k2, (max(n_local // 4, 1), D),
                                    minval=-1.0, maxval=1.0)
            return pigs.pigs_loss(cfg, f, x, dx, u_star(dx), f_rhs,
                                  method="tiled")

        loss_grad = jax.jit(jax.value_and_grad(shard_loss, has_aux=True))
        tot, grads = None, None
        for k in colloc_keys:
            (l, metrics), g = loss_grad(field, k)
            assert metrics["bin_overflow"] == 0, metrics
            assert metrics["entry_overflow"] == 0, metrics
            tot = l if tot is None else tot + l
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        n = len(colloc_keys)
        return tot / n, jax.tree.map(lambda g: g / n, grads)

    def compare(name, metrics, grads, ref_loss, ref_grads, placement):
        errs = {k: _rel_err(a, b) for k, a, b in zip(
            field._fields, jax.tree.leaves(grads),
            jax.tree.leaves(ref_grads))}
        loss_err = abs(float(metrics["loss"]) - float(ref_loss)) / abs(
            float(ref_loss))
        log(name, loss=float(metrics["loss"]), one_card_loss=float(ref_loss),
            loss_rel_err=loss_err, grad_rel_err=errs, tol=TOL_GRADS,
            overflow={k: float(metrics[k]) for k in
                      ("bin_overflow", "entry_overflow")},
            devices=placement)
        assert len(placement) == 4, placement
        assert loss_err <= TOL_GRADS, (name, loss_err)
        assert all(e <= TOL_GRADS for e in errs.values()), (name, errs)
        assert metrics["bin_overflow"] == 0 and metrics["entry_overflow"] == 0

    # Sample-sharded (data-parallel) step on a (4, 1) mesh.
    mesh = pmesh.make_mesh((4, 1), devices=devs)
    step = pmesh.make_sharded_pigs_step(cfg, mesh, opt, f_rhs, u_star,
                                        n_collocation=N, method="tiled")
    state = pmesh.replicate(
        pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32)),
        mesh)
    t0 = time.perf_counter()
    new, metrics = jax.block_until_ready(step(state, key))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(step(state, key))
    t_step = time.perf_counter() - t0
    grads = new.opt_state["g"]
    placement = sorted({str(d) for x in jax.tree.leaves(grads)
                        for d in x.sharding.device_set})
    ref_loss, ref_grads = one_card_loss(
        jax.device_put(field, devs[0]), list(jax.random.split(key, 4)),
        N // 4)
    compare("four_cards_data_sharded", metrics, grads, ref_loss,
            ref_grads, placement)
    log("four_cards_data_sharded_time", step_s=t_step, first_call_s=t_first)

    # Gaussian-sharded step (params and optimizer state over 'model').
    mesh = pmesh.make_mesh((1, 4), devices=devs)
    step_s, shard_field = pmesh.make_model_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=N, method="tiled")
    state = pigs.TrainState(shard_field(field), shard_field(opt.init(field)),
                            jnp.zeros((), jnp.int32))
    t0 = time.perf_counter()
    new, metrics = jax.block_until_ready(step_s(state, key))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(step_s(state, key))
    t_step = time.perf_counter() - t0
    grads = new.opt_state["g"]
    placement = sorted({str(d) for x in jax.tree.leaves(grads)
                        for d in x.sharding.device_set})
    ref_loss, ref_grads = one_card_loss(
        jax.device_put(field, devs[0]), [jax.random.split(key, 1)[0]],
        N // 4)
    compare("four_cards_model_sharded", metrics, grads, ref_loss,
            ref_grads, placement)
    log("four_cards_model_sharded_time", step_s=t_step, first_call_s=t_first)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded config-5 steps on 4 cards")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dgs.utils.cache import enable_compile_cache

    enable_compile_cache()
    n_cards = 4 if args.four_cards else 1
    phase_device(n_cards)
    if args.four_cards:
        phase_four_cards()
    else:
        for phase in (phase_parity, phase_headline, phase_pigs,
                      phase_dynamics, phase_gpu_tests):
            t0 = time.perf_counter()
            phase()
            log(phase.__name__, done=True, wall_s=time.perf_counter() - t0)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
