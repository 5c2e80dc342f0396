"""Sharded execution on the virtual 8-device CPU mesh.

Validates the (data=samples, model=gaussians) sharding: partial-mixture psum
over 'model', gradient all-reduce over 'data', parity with single-device
results (SURVEY.md sections 5 and 7; config 5 of BASELINE.json).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dgs.config import SamplerConfig
from dgs.models import pigs
from dgs.models.field import init_field
from dgs.oracle import dense as oracle
from dgs.parallel import mesh as pmesh

from conftest import make_gaussians, make_samples

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_sharded_dense_matches_oracle(rng):
    mesh = pmesh.make_mesh((4, 2))
    means, values, covs, conics = make_gaussians(rng, 32, 2, 3)
    samples = make_samples(rng, 64, 2)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))
    cfg = SamplerConfig()
    outs = pmesh.sharded_sample_all(
        cfg, mesh, m, v, c, cov, s, orders=("value", "derivative"),
        method="dense",
    )
    for order in ("value", "derivative"):
        ref = oracle.evaluate(order, m, v, c, s)
        np.testing.assert_allclose(outs[order], ref, rtol=2e-4, atol=1e-5)


def test_sharded_tiled_matches_unsharded(rng):
    mesh = pmesh.make_mesh((4, 2))
    means, values, covs, conics = make_gaussians(
        rng, 32, 2, 2, sigma_range=(0.15, 0.3)
    )
    samples = make_samples(rng, 64, 2)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))
    cfg = SamplerConfig()
    got = pmesh.sharded_sample_all(
        cfg, mesh, m, v, c, cov, s, orders=("value",), method="tiled"
    )["value"]
    from dgs.ops import sampling

    ref, diag = sampling.sample_binned(cfg, m, v, c, cov, s, ("value",))
    assert int(diag["bin_overflow"]) == 0
    np.testing.assert_allclose(got, ref["value"], rtol=2e-4, atol=1e-5)


@pytest.mark.slow
def test_sharded_training_step_runs_and_learns():
    mesh = pmesh.make_mesh((4, 2))
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(0), 64, 2, 1, sigma=0.25)
    opt = optax.adam(1e-2)
    state = pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32))
    state = pmesh.replicate(state, mesh)
    step = pmesh.make_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=256, method="dense"
    )
    key = jax.random.PRNGKey(1)
    first = None
    for i in range(30):
        key, sub = jax.random.split(key)
        state, metrics = step(state, sub)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first


def test_sharded_grads_match_unsharded():
    mesh = pmesh.make_mesh((4, 2))
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(5), 32, 2, 1, sigma=0.3)
    x = jax.random.uniform(jax.random.PRNGKey(6), (64, 2), minval=-1, maxval=1)
    data_u = u_star(x)

    def loss(f):
        l, _ = pigs.pigs_loss(cfg, f, x, x, data_u, f_rhs, method="dense")
        return l

    g_ref = jax.grad(loss)(field)

    from functools import partial
    from jax.sharding import PartitionSpec as P

    @partial(jax.shard_map, mesh=mesh, check_vma=False, in_specs=(P(), P(("data", "model"))),
             out_specs=P())
    def sharded_grad(f, xs):
        def local(f_):
            outs, _ = pigs.field_outputs(
                cfg, f_, xs, orders=("value", "laplacian"), method="dense"
            )
            lap = jnp.trace(outs["laplacian"], axis1=1, axis2=2)
            res = -lap - f_rhs(xs)
            du = outs["value"] - u_star(xs)
            return jax.lax.pmean(
                jnp.mean(res**2) + jnp.mean(du**2), ("data", "model")
            )

        return jax.tree.map(
            lambda g: jax.lax.pmean(g, ("data", "model")), jax.grad(local)(f)
        )

    g_shard = sharded_grad(field, x)
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_shard)):
        if a.size:
            np.testing.assert_allclose(
                b, a, rtol=2e-3, atol=1e-5 * max(1.0, float(np.abs(a).max()))
            )


def test_model_sharded_step_matches_replicated():
    """Gaussian-sharded step (params + optimizer state over 'model', partial
    mixture psum, shard-local updates) must produce the same loss and updated
    parameters as the replicated step on a (1, M) mesh with matching
    collocation sampling."""
    M = 4
    mesh_m = pmesh.make_mesh((1, M), devices=jax.devices()[:M])
    mesh_1 = pmesh.make_mesh((1, 1), devices=jax.devices()[:1])
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(7), 32, 2, 1, sigma=0.3)
    opt = optax.adam(1e-2)
    n_col = 64 * M  # model-sharded divides by M -> 64 local, same as (1,1)

    step_m, shard_field = pmesh.make_model_sharded_pigs_step(
        cfg, mesh_m, opt, f_rhs, u_star, n_collocation=n_col, method="dense"
    )
    state_m = pigs.TrainState(
        shard_field(field), shard_field(opt.init(field)),
        jnp.zeros((), jnp.int32),
    )
    step_r = pmesh.make_sharded_pigs_step(
        cfg, mesh_1, opt, f_rhs, u_star, n_collocation=n_col // M,
        method="dense",
    )
    state_r = pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32))
    state_r = pmesh.replicate(state_r, mesh_1)

    key = jax.random.PRNGKey(8)
    state_m, met_m = step_m(state_m, key)
    state_r, met_r = step_r(state_r, key)
    np.testing.assert_allclose(
        float(met_m["loss"]), float(met_r["loss"]), rtol=1e-5
    )
    for a, b in zip(jax.tree.leaves(state_m.field),
                    jax.tree.leaves(state_r.field)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.slow
def test_model_sharded_step_learns_tiled():
    mesh = pmesh.make_mesh((4, 2))
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(0), 64, 2, 1, sigma=0.25)
    opt = optax.adam(1e-2)
    step, shard_field = pmesh.make_model_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=512, method="tiled"
    )
    state = pigs.TrainState(
        shard_field(field), shard_field(opt.init(field)),
        jnp.zeros((), jnp.int32),
    )
    key = jax.random.PRNGKey(1)
    first = None
    for i in range(30):
        key, sub = jax.random.split(key)
        state, metrics = step(state, sub)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first


def test_sharded_step_compiles_collectives():
    """The compiled sharded programs must contain real collectives: the
    replicated step's gradient all-reduce, and the model-sharded step's
    partial-mixture psum (both are NCCL collectives on the cards)."""
    mesh = pmesh.make_mesh((4, 2))
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(0), 64, 2, 1, sigma=0.25)
    opt = optax.adam(1e-2)

    step = pmesh.make_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=256, method="dense"
    )
    state = pmesh.replicate(
        pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32)),
        mesh,
    )
    txt = step.lower(state, jax.random.PRNGKey(1)).compile().as_text()
    assert "all-reduce" in txt

    step_m, shard_field = pmesh.make_model_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=256, method="dense"
    )
    state_m = pigs.TrainState(
        shard_field(field), shard_field(opt.init(field)),
        jnp.zeros((), jnp.int32),
    )
    txt_m = step_m.lower(state_m, jax.random.PRNGKey(1)).compile().as_text()
    assert "all-reduce" in txt_m


def test_chunked_grad_allreduce_overlap_structure():
    """grad_chunks=M must EMIT M distinct gradient all-reduces (one per
    microbatch, each independent of the later chunks' backward compute -
    the structure XLA's latency-hiding scheduler overlaps on real
    multi-chip hardware; SURVEY.md section 7), and the step must still
    learn.  Counted on the pre-optimization lowering: the backend's
    combiner pass may later merge small reductions (it does on the CPU
    mesh, where tensors are tiny and combining beats overlap - that
    choice is the scheduler's, driven by the combine-threshold flags)."""
    mesh = pmesh.make_mesh((4, 2))
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(0), 64, 2, 1, sigma=0.25)
    opt = optax.adam(1e-2)
    state = pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32))
    state = pmesh.replicate(state, mesh)

    def n_allreduce(step):
        txt = step.lower(state, jax.random.PRNGKey(1)).as_text()
        return txt.count("stablehlo.all_reduce")

    step1 = pmesh.make_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=256, method="dense",
        grad_chunks=1)
    step4 = pmesh.make_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=256, method="dense",
        grad_chunks=4)
    n1, n4 = n_allreduce(step1), n_allreduce(step4)
    assert n4 >= n1 + 3, (n1, n4)

    key = jax.random.PRNGKey(1)
    first = None
    for _ in range(30):
        key, sub = jax.random.split(key)
        state, metrics = step4(state, sub)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first


def test_chunked_grad_allreduce_independence_in_compiled_hlo():
    """Schedule-level overlap evidence on the compiled module (SURVEY.md
    section 7 last bullet).  The CPU backend's AllReduceCombiner merges
    small per-chunk reductions (up to 256 ops per group), and its
    sequential scheduler places collectives without latency hiding - so an
    instruction-ORDER assertion is vacuous here.  What CAN be asserted on
    the virtual mesh, after all combining, is the dependence structure a
    latency-hiding scheduler needs: with enough chunks to force >1
    combined all-reduce, the FIRST combined all-reduce must be transitively
    independent of the compute feeding the second - i.e. the compiled
    program still contains a reduction that can be issued while a large
    body of backward compute is outstanding."""
    import re

    CH = 64  # 64 chunks x 5 grad groups > the combiner's 256-op group cap
    mesh = pmesh.make_mesh((4, 2))
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(0), 64, 2, 1, sigma=0.25)
    opt = optax.adam(1e-2)
    state = pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32))
    state = pmesh.replicate(state, mesh)
    step = pmesh.make_sharded_pigs_step(
        cfg, mesh, opt, f_rhs, u_star, n_collocation=8 * CH * 4,
        method="dense", grad_chunks=CH)
    txt = step.lower(state, jax.random.PRNGKey(1)).compile().as_text()

    # Parse the ENTRY computation: instruction name -> operand names.
    entry_lines, in_entry = [], False
    for l in txt.splitlines():
        if l.startswith("ENTRY"):
            in_entry = True
            continue
        if in_entry:
            if l.startswith("}"):
                break
            entry_lines.append(l)
    deps, ars = {}, []
    for l in entry_lines:
        m = re.match(r"\s*(%[\w.\-]+) = .*?\((.*)", l)
        if not m:
            continue
        deps[m.group(1)] = re.findall(r"%[\w.\-]+", m.group(2))
        if re.search(r"= .*all-reduce\(", l):
            ars.append(m.group(1))
    assert len(ars) >= 2, (
        f"expected the 256-op combiner cap to split {CH} chunks' reductions "
        f"into >= 2 combined all-reduces, found {ars}")

    import functools
    import sys

    sys.setrecursionlimit(100_000)

    @functools.lru_cache(maxsize=None)
    def reach(n):
        out = set()
        for o in deps.get(n, ()):
            if o in deps:
                out.add(o)
                out |= reach(o)
        return frozenset(out)

    # Order the ARs by how much feeds them; the smaller one is "first".
    ars = sorted(ars, key=lambda a: len(reach(a)))
    first, second = ars[0], ars[-1]
    assert second not in reach(first), "combined ARs must be independent"
    only_second = reach(second) - reach(first) - {first}
    compute = [n for n in only_second if "fusion" in n or "dot" in n]
    # A large body of compute feeds only the second reduction: the first
    # can be in flight while all of it runs.
    assert len(compute) > 100, (len(only_second), len(compute))

    # Scheduling-dump evidence (SURVEY.md section 7 "verify overlap with
    # profiler traces"): the compiled entry computation's
    # textual order IS the backend's sequential schedule.  The CPU
    # scheduler does not hoist collectives (no latency hiding), so the
    # meaningful schedule-level fact is READINESS: every operand of the
    # first combined all-reduce is scheduled while a large body of the
    # backward compute feeding only the later reduction is still
    # outstanding - the earliest legal issue slot for the collective
    # precedes that compute, which is exactly the window a latency-hiding
    # scheduler uses to overlap it with compute.
    pos = {}
    for i, l in enumerate(entry_lines):
        m = re.match(r"\s*(%[\w.\-]+) = ", l)
        if m:
            pos[m.group(1)] = i
    ready = max((pos[o] for o in deps.get(first, ()) if o in pos),
                default=0)
    outstanding = [n for n in compute if pos.get(n, -1) > ready]
    assert len(outstanding) > 100, (
        f"first all-reduce {first} becomes ready at schedule position "
        f"{ready} but only {len(outstanding)} backward-compute ops of the "
        f"later chunks are scheduled after that point")


@pytest.mark.slow
def test_sharded_aggregation_matches_unsharded():
    """Model-parallel neighbor aggregation (tile-range shards, SURVEY.md
    section 5 comm-backend row - the second subsystem's distribution
    story): outputs AND all six parameter-group gradients from the sharded
    step must match the single-structure Pallas path on the virtual mesh,
    and the compiled program must contain a real collective."""
    from dgs.ops import aggregation
    from dgs.oracle.dense import radii as compute_radii
    from conftest import make_gaussians

    rng = np.random.default_rng(11)
    means, _, covs, conics = make_gaussians(rng, 80, 2, 4,
                                            sigma_range=(0.05, 0.2))
    m, cov, c = map(jnp.asarray, (means, covs, conics))
    cfg = SamplerConfig(eig_floor=1e-12)
    rad = compute_radii(cov, 2, cfg.radius_sigma, cfg.eig_floor)

    P_, L, K, nfreq = 80, 4, 3, 2
    E = nfreq * 2 * 2 + 1
    r = np.random.default_rng(5)
    params = {
        "features": jnp.asarray(r.normal(size=(P_, L)).astype(np.float32)),
        "transform": jnp.asarray(r.normal(size=(L, L)).astype(np.float32)),
        "queries": jnp.asarray(r.normal(size=(P_, K)).astype(np.float32)),
        "keys": jnp.asarray(r.normal(size=(P_, K)).astype(np.float32)),
        "frequencies": jnp.asarray(
            np.arange(1.0, nfreq + 1).astype(np.float32)),
        "distance_transform": jnp.asarray(
            r.normal(size=(2 * E,)).astype(np.float32)),
    }

    # Unsharded reference.
    cfg2, plan = aggregation.plan_pallas(cfg, m, rad, block_n=16)
    agg = aggregation.preprocess_pallas(cfg2, m, c, rad, plan, 16, 128)
    assert int(agg.overflow) == 0

    def loss_ref(p):
        out = aggregation.aggregate_pallas(
            p["features"], p["transform"], p["queries"], p["keys"],
            p["frequencies"], p["distance_transform"], agg,
            block_n=16,
        )
        return jnp.sum(out * jnp.cos(out)), out

    # Sharded over model=4.
    mesh = pmesh.make_mesh((2, 4))
    cfg3, plan_s, aggs = pmesh.build_sharded_aggregation(
        cfg, m, c, rad, 4, block_n=16)
    assert cfg3.tile_size == cfg2.tile_size
    assert int(jnp.sum(aggs.overflow)) == 0

    def loss_sh(p):
        out = pmesh.sharded_aggregate(
            mesh, p["features"], p["transform"], p["queries"], p["keys"],
            p["frequencies"], p["distance_transform"], aggs,
            block_n=16,
        )
        return jnp.sum(out * jnp.cos(out)), out

    (l_ref, out_ref), g_ref = jax.value_and_grad(loss_ref, has_aux=True)(params)
    (l_sh, out_sh), g_sh = jax.value_and_grad(loss_sh, has_aux=True)(params)
    np.testing.assert_allclose(out_sh, out_ref, rtol=2e-4, atol=1e-5)
    for k in sorted(g_ref):
        np.testing.assert_allclose(
            g_sh[k], g_ref[k], rtol=3e-4,
            atol=1e-4 * max(1.0, float(np.abs(g_ref[k]).max())),
            err_msg=f"dL/d{k}",
        )

    # The compiled sharded program must contain a real collective.
    txt = (jax.jit(lambda p: loss_sh(p)[0]).lower(params).compile().as_text())
    assert "all-reduce" in txt


@pytest.mark.slow
def test_sharded_dynamics_step_learns():
    """One jitted model-sharded dynamics training step runs end-to-end on
    the virtual mesh and reduces the loss (the aggregation subsystem's
    sharded training step; dryrun_multichip runs the same composition)."""
    import optax
    from dgs.models import dynamics
    from dgs.oracle.dense import radii as compute_radii
    from conftest import make_gaussians

    rng = np.random.default_rng(3)
    means, values, covs, conics = make_gaussians(rng, 60, 2, 1,
                                                 sigma_range=(0.08, 0.25))
    m, v, cov, c = map(jnp.asarray, (means, values, covs, conics))
    cfg = SamplerConfig(eig_floor=1e-12)
    rad = compute_radii(cov, 2, cfg.radius_sigma, cfg.eig_floor)
    mesh = pmesh.make_mesh((2, 4))
    _, _, aggs = pmesh.build_sharded_aggregation(cfg, m, c, rad, 4,
                                                 block_n=16)
    params = dynamics.init_dynamics_params(
        jax.random.PRNGKey(0), 60, 1, 2, ladder=True)
    target = v * 0.9
    opt = optax.adam(1e-2)
    step = pmesh.make_sharded_dynamics_step(
        mesh, opt, aggs, v, target, rollout=2, ladder_frequencies=True,
        block_n=16)
    opt_state = opt.init(params)
    losses = []
    for _ in range(12):
        params, opt_state, l = step(params, opt_state)
        losses.append(float(l))
    assert losses[-1] < losses[0], losses
