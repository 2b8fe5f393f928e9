"""End-to-end solver tests.

The reference's end-to-end test is a stub (tests/test_solver.py:10-11); the
de-facto oracle is its committed main.py experiment: 937 CP iterations to
tol 1e-3 with final residuals (9.95e-4, 9.41e-4, 9.56e-4) — reproduced here
exactly (float64). Plus convergence + feasibility checks on a second family.
"""

import numpy as np
import pytest

from raocp_tpu import Solver
from raocp_tpu.models import demo_problem, lqr_binary_problem


@pytest.fixture(scope="module")
def demo_result():
    problem, x0 = demo_problem()
    solver = Solver(problem)
    result = solver.solve(x0, max_iters=2000, tol=1e-3)
    return problem, solver, result


def test_reference_iteration_parity(demo_result):
    """The strongest oracle: same math => same iterate sequence => same
    iteration count and final residuals as the reference experiment
    (reference 4-3-residuals.tex:965,1906,2847)."""
    _, _, result = demo_result
    assert result.status == 0 and result.converged
    assert result.num_iters == 937
    np.testing.assert_allclose(
        result.xi, [9.9508e-4, 9.4106e-4, 9.5599e-4], rtol=1e-3)


def test_residual_history_monotone_tail(demo_result):
    _, _, result = demo_result
    hist = result.xi_history
    assert hist.shape == (937, 3)
    assert hist[0, 0] == pytest.approx(2.143, rel=1e-2)  # reference k=0 value
    # residuals decrease over the run (loosely: final < initial / 100)
    assert hist[-1].max() < hist[0].max() / 100


def test_solution_feasibility(demo_result):
    problem, _, result = demo_result
    tree = problem.tree
    x = result.primal.x
    u = result.primal.u
    # dynamics hold exactly (the prox ends with a forward rollout)
    for j in range(1, tree.num_nodes):
        i = tree.ancestor_of(j)
        np.testing.assert_allclose(
            x[j], problem.state_dynamics_at_node(j) @ x[i]
            + problem.control_dynamics_at_node(j) @ u[i], atol=1e-8)
    # box constraints hold up to the residual tolerance
    assert u.max() <= 0.1 + 1e-3 and u.min() >= -0.1 - 1e-3
    assert abs(x).max() <= 7 + 1e-3


def test_not_converged_status():
    problem, x0 = demo_problem()
    result = Solver(problem).solve(x0, max_iters=5, tol=1e-3)
    assert result.status == 1 and not result.converged
    assert result.num_iters == 6  # reference loop runs max_iters+1 bodies


def test_lqr_binary_converges():
    problem, x0 = lqr_binary_problem()
    result = Solver(problem).solve(x0, max_iters=5000, tol=1e-4)
    assert result.converged
    assert result.xi.max() <= 1e-4


def test_chock_parity_api():
    problem, x0 = lqr_binary_problem()
    solver = Solver(problem)
    status = solver.chock(initial_state=x0, max_iters=5000, tol=1e-4)
    assert status == 0
    assert solver.result.converged


def test_soc_network_converges_and_feasible():
    """BASELINE config 3 shape (ball/SOC state-input constraints): the
    solver converges and the solution respects the norm balls."""
    from raocp_tpu.models import soc_network_problem

    problem, x0 = soc_network_problem(num_states=4, num_inputs=2,
                                      num_modes=2, num_stages=4,
                                      stopping_time=2)
    solver = Solver(problem)
    res = solver.solve(x0, max_iters=8000, tol=1e-3)
    assert res.status == 0
    sp = solver.stacked
    NL, N = sp.num_nonleaf, sp.num_nodes
    xu = np.concatenate([res.primal.x[:NL], res.primal.u[:NL]], axis=1)
    assert np.linalg.norm(xu, axis=1).max() <= 10.0 + 1e-2
    assert np.linalg.norm(res.primal.x[NL:N], axis=1).max() <= 10.0 + 1e-2


def test_validate_solution(demo_result):
    """The post-solve self-check (the reference's runtime kernel assertion,
    cache.py:311-312, as a one-shot validation)."""
    _, solver, result = demo_result
    v = solver.validate(result)
    # prox_f projects exactly onto dynamics/kernel; CP leaves O(tol)
    # violations only through the dual constraint handling
    assert v["dynamics"] < 1e-8
    assert v["kernel"] < 1e-8
    assert v["constraints"] < 1e-2


def test_validate_flags_infeasible_point(demo_result):
    """validate must DETECT violations, not just pass good solutions: a
    corrupted primal trips all three checks (the spec-oracle spot check
    covers the constraint path independently of the stacked tables)."""
    import dataclasses as dc

    _, solver, result = demo_result
    bad_primal = result.primal._replace(
        x=np.asarray(result.primal.x) + 100.0)
    bad = dc.replace(result, primal=bad_primal)
    v = solver.validate(bad)
    assert v["dynamics"] > 1.0
    assert v["constraints"] > 1.0
    # the setup plan is cached per solver: second call reuses it
    assert solver._validate_plan() is solver._validate_plan()


def test_anderson_acceleration_converges_faster():
    """Safeguarded Anderson acceleration (BASELINE config 4's accelerated
    iterations): converges to the same solution in fewer iterations."""
    from raocp_tpu.models import demo_problem

    problem, x0 = demo_problem()
    solver = Solver(problem)
    plain = solver.solve(x0, max_iters=2000, tol=1e-3)
    acc = solver.solve(x0, max_iters=2000, tol=1e-3, accel="anderson")
    assert acc.status == 0
    assert acc.num_iters < plain.num_iters
    # same fixed point up to tolerance
    dx = np.abs(np.asarray(plain.primal.x) - np.asarray(acc.primal.x)).max()
    assert dx < 1e-2


def test_periodic_convergence_checks():
    """check_every=k: same iterate sequence, stopping test evaluated only
    every k-th step — converges at a multiple of k, not before the plain
    stopping iteration, to an equally feasible point."""
    from raocp_tpu.models import demo_problem

    problem, x0 = demo_problem()
    solver = Solver(problem)
    plain = solver.solve(x0, max_iters=2000, tol=1e-3)
    strided = solver.solve(x0, max_iters=2000, tol=1e-3, check_every=5)
    assert strided.status == 0
    assert strided.num_iters % 5 == 0
    assert strided.num_iters >= plain.num_iters
    assert float(strided.xi.max()) <= 1e-3
    dx = np.abs(np.asarray(plain.primal.x)
                - np.asarray(strided.primal.x)).max()
    assert dx < 1e-2


def test_supermann_acceleration_converges_faster():
    """SuperMann globalisation with limited-memory Broyden directions
    (BASELINE config 4's 'SuperMann/L-BFGS accelerated iterations'):
    converges to the same solution in fewer iterations, and its safeguard
    keeps the solution feasible."""
    from raocp_tpu.models import demo_problem

    problem, x0 = demo_problem()
    solver = Solver(problem)
    plain = solver.solve(x0, max_iters=2000, tol=1e-3)
    acc = solver.solve(x0, max_iters=2000, tol=1e-3, accel="supermann")
    assert acc.status == 0
    assert acc.num_iters < plain.num_iters
    dx = np.abs(np.asarray(plain.primal.x) - np.asarray(acc.primal.x)).max()
    assert dx < 1e-2
    v = solver.validate(acc)
    assert v["dynamics"] < 1e-8 and v["kernel"] < 1e-8


def test_accel_strided_checks():
    """check_every under acceleration: the safeguards run on the free
    fixed-point residual every iteration, only the xi stopping test is
    strided — so the loop stops at a multiple of the stride, converged,
    with NaN history gaps between checks."""
    from raocp_tpu.models import demo_problem

    problem, x0 = demo_problem()
    solver = Solver(problem)
    for accel in ("anderson", "supermann"):
        res = solver.solve(x0, max_iters=2000, tol=1e-3, accel=accel,
                           check_every=5)
        assert res.status == 0, accel
        assert res.num_iters % 5 == 0, accel
        assert float(res.xi.max()) <= 1e-3, accel
        # rows between checks are NaN gaps; checked rows are finite
        assert np.isnan(res.xi_history[0]).all(), accel
        assert np.isfinite(res.xi_history[4::5]).all(), accel
        v = solver.validate(res)
        assert v["dynamics"] < 1e-8 and v["kernel"] < 1e-8


def test_step_ratio_balancing():
    """alpha1 = gamma*alpha, alpha2 = alpha/gamma keeps the CP convergence
    product alpha1*alpha2 unchanged: any gamma > 0 converges; gamma != 1
    produces a different (still convergent) iterate sequence; gamma = 1 is
    the reference rule (the 937-parity test covers it)."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    res = solver.solve(x0, max_iters=5000, tol=1e-3, step_ratio=2.0)
    assert res.converged
    assert res.num_iters != 937        # different sequence
    checks = solver.validate()
    assert checks["dynamics"] < 1e-8 and checks["kernel"] < 1e-8
    with pytest.raises(ValueError):
        solver.solve(x0, max_iters=10, tol=1e-3, step_ratio=0.0)


def test_adaptive_step_balancing():
    """Residual balancing (adaptive PDHG): converges to a feasible point on
    the demo, and with strided checks the rebalancing happens only at check
    iterations (same code path the production config uses)."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    res = solver.solve(x0, max_iters=5000, tol=1e-3, adaptive=True)
    assert res.converged
    checks = solver.validate()
    assert checks["dynamics"] < 1e-8 and checks["kernel"] < 1e-8
    res_strided = solver.solve(x0, max_iters=5000, tol=1e-3, adaptive=True,
                               check_every=25)
    assert res_strided.converged


def test_objective_matches_risk_recursion(demo_result):
    """result.objective (the root epigraph variable s_0) must equal an
    independent host-side evaluation of the nested risk-recursive cost of
    the returned trajectory (LP per node over the ambiguity set) — an
    end-to-end oracle of the whole conic epigraph formulation. The
    reference never surfaces the optimal cost (its cost evaluator is dead
    code, costs.py:65-87)."""
    from raocp_tpu.utils.evaluate import risk_value

    problem, _, result = demo_result
    v0 = risk_value(problem, result.primal.x, result.primal.u)
    assert result.objective == pytest.approx(v0, abs=2e-2, rel=1e-2)


def test_objective_matches_risk_recursion_tv():
    """Same oracle with a TotalVariation risk (nonzero F ambiguity set)."""
    from raocp_tpu.models import demo_problem as _demo
    from raocp_tpu import TotalVariation
    from raocp_tpu.utils.evaluate import risk_value

    problem, x0 = _demo(risk=TotalVariation(0.5))
    result = Solver(problem).solve(x0, max_iters=8000, tol=1e-4)
    assert result.converged
    v0 = risk_value(problem, result.primal.x, result.primal.u)
    assert result.objective == pytest.approx(v0, abs=2e-2, rel=1e-2)


def test_over_relaxation_converges_faster():
    """Relaxed CP (Condat 2013): rho in (0, 2) over-relaxes each proximal
    step at no extra operator applies. rho = 1.5 must converge to a point
    satisfying the same feasibility oracles in FEWER iterations than the
    937 of plain CP (the relaxed fixed-point iteration contracts faster)."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    res = solver.solve(x0, max_iters=2000, tol=1e-3, relax=1.5)
    assert res.converged
    assert res.num_iters < 937
    checks = solver.validate(res)
    assert checks["dynamics"] < 1e-8 and checks["kernel"] < 1e-8
    assert checks["constraints"] < 1e-2


def test_relax_out_of_range_raises():
    problem, x0 = demo_problem()
    solver = Solver(problem)
    with pytest.raises(ValueError, match="relax"):
        solver.solve(x0, max_iters=10, relax=2.0)
    with pytest.raises(ValueError, match="relax"):
        solver.solve(x0, max_iters=10, relax=0.0)


def test_relax_composes_with_production_loop_config():
    """relax must apply identically inside the statically-placed-check
    branch (unroll == check_every, the production configuration)."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    res = solver.solve(x0, max_iters=2000, tol=1e-3, relax=1.5,
                       check_every=25, unroll=25)
    assert res.converged
    checks = solver.validate(res)
    assert checks["dynamics"] < 1e-8 and checks["kernel"] < 1e-8


def test_partial_unroll_matches_unrolled_checks():
    """unroll < check_every (the large-problem production configuration):
    since unroll divides check_every, only a trip's last step can land on
    a check boundary — the solver skips the dead cond/history slots on
    the other unroll-1 steps statically. Iterates, stopping iteration,
    and the set of checked history rows must all match unroll=1
    exactly."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    r1 = solver.solve(x0, max_iters=2000, tol=1e-3, check_every=25,
                      unroll=1)
    r5 = solver.solve(x0, max_iters=2000, tol=1e-3, check_every=25,
                      unroll=5)
    assert r5.num_iters == r1.num_iters
    np.testing.assert_allclose(r5.xi, r1.xi, rtol=0, atol=1e-14)
    dx = np.abs(np.asarray(r1.primal.x) - np.asarray(r5.primal.x)).max()
    assert dx < 1e-12
    rows1 = np.where(~np.isnan(r1.xi_history[:, 0]))[0]
    rows5 = np.where(~np.isnan(r5.xi_history[:, 0]))[0]
    assert np.array_equal(rows1, rows5)
    np.testing.assert_allclose(r5.xi_history[rows5], r1.xi_history[rows1],
                               rtol=0, atol=1e-14)


def test_solve_batch_elementwise_parity():
    """solve_batch vmaps the whole CP loop over initial states with exact
    per-element stopping (converged lanes freeze): the element carrying the
    reference initial state must reproduce the single-solve's 937
    iterations, and every element must satisfy the feasibility oracles."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    x0s = np.stack([np.asarray(x0), 0.5 * np.asarray(x0),
                    -0.3 * np.asarray(x0)])
    results = solver.solve_batch(x0s, max_iters=2000, tol=1e-3)
    assert len(results) == 3
    assert all(r.converged for r in results)
    assert results[0].num_iters == 937
    single = solver.solve(x0, max_iters=2000, tol=1e-3)
    np.testing.assert_allclose(results[0].primal.x, single.primal.x,
                               atol=1e-12)
    for r in results:
        checks = solver.validate(r)
        assert checks["dynamics"] < 1e-8 and checks["kernel"] < 1e-8


def test_solve_batch_validation():
    problem, x0 = demo_problem()
    solver = Solver(problem)
    with pytest.raises(ValueError, match="initial_states"):
        solver.solve_batch(np.asarray(x0), max_iters=10)


def test_operator_norm_memoised(monkeypatch):
    """One power iteration per Solver: repeated solves (MPC warm-start
    loops) must not re-estimate ||L|| on an unchanged problem."""
    import raocp_tpu.solver as solver_mod

    calls = {"n": 0}
    real = solver_mod._power_iteration

    def counting(sp, *a, **k):
        calls["n"] += 1
        return real(sp, *a, **k)

    monkeypatch.setattr(solver_mod, "_power_iteration", counting)
    problem, x0 = lqr_binary_problem(num_stages=3)
    solver = Solver(problem)
    solver.solve(x0, max_iters=50, tol=1e-3)
    solver.solve(x0, max_iters=50, tol=1e-3)
    solver.solve_batch(np.stack([np.asarray(x0)] * 2), max_iters=50,
                       tol=1e-3)
    assert calls["n"] == 1
    # a fresh Solver estimates again (no cross-instance leakage)
    solver2 = Solver(problem)
    solver2.solve(x0, max_iters=50, tol=1e-3)
    assert calls["n"] == 2


def test_solve_batch_clears_current_result():
    """After solve_batch there is no single 'current' result: a no-arg
    validate() must fail loudly instead of silently reusing a stale
    single-solve result."""
    problem, x0 = demo_problem()
    solver = Solver(problem)
    solver.solve(x0, max_iters=50, tol=1e-3)
    assert solver.result is not None
    solver.solve_batch(np.stack([np.asarray(x0)]), max_iters=50, tol=1e-3)
    assert solver.result is None
    with pytest.raises(RuntimeError, match="no solve result"):
        solver.validate()


def test_wasserstein_empty_ball_rejected():
    """A ground cost whose cheapest feasible plan exceeds the radius makes
    the ambiguity set empty — realization must reject it, not let the CP
    solve silently stall (ADVICE r2)."""
    from raocp_tpu import Wasserstein
    from raocp_tpu.models import demo_problem as _demo

    bad_cost = np.ones((3, 3))          # every move (even staying) costs 1
    with pytest.raises(ValueError, match="empty Wasserstein"):
        _demo(risk=Wasserstein(0.5, ground_cost=bad_cost))


def test_relax_auto_resolves(demo_result):
    """relax='auto' resolves to the measured-win 1.8 (identical program);
    unknown strings are rejected. The DEFAULT stays 1.0 — reference
    parity (the 937 gate above) — while long-solve paths (MPC) default
    to 'auto'."""
    import inspect

    from raocp_tpu.mpc import RiskAverseMPC
    from raocp_tpu.solver import _AUTO_RELAX

    problem, solver, _ = demo_result
    _, x0 = demo_problem()
    auto = solver.solve(x0, max_iters=2000, tol=1e-3, relax="auto")
    explicit = solver.solve(x0, max_iters=2000, tol=1e-3,
                            relax=_AUTO_RELAX)
    assert auto.num_iters == explicit.num_iters
    np.testing.assert_allclose(auto.xi_history, explicit.xi_history,
                               atol=0.0)
    with pytest.raises(ValueError, match="unknown relax"):
        solver.solve(x0, max_iters=10, relax="fast")
    assert inspect.signature(RiskAverseMPC.run).parameters["relax"] \
        .default == "auto"


def test_chunked_solve_matches_plain(demo_result):
    """chunk_iters bounds each device execution and resumes from the
    device-resident iterate: the chunked solve must reproduce the plain
    solve exactly — same 937 iterations, same residual history, same
    iterates (chunk boundaries land on residual checks)."""
    problem, solver, plain = demo_result
    _, x0 = demo_problem()
    chunked = solver.solve(x0, max_iters=2000, tol=1e-3, chunk_iters=300)
    assert chunked.converged and chunked.num_iters == plain.num_iters
    np.testing.assert_allclose(chunked.xi_history, plain.xi_history,
                               atol=1e-12)
    for a, b in zip(chunked.primal, plain.primal):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12)


def test_chunked_solve_elastic_recovery(demo_result, monkeypatch, tmp_path):
    """Elastic recovery of chunked solves: a transient device fault
    mid-chunk is retried, with a warning that names it, from the last host
    snapshot with identical results; a persistent fault writes a resume
    checkpoint."""
    import jax

    import raocp_tpu.solver as solver_mod

    problem, solver, plain = demo_result
    _, x0 = demo_problem()
    real_run = solver_mod._run_cp
    calls = {"n": 0}

    def flaky_run(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:      # fault during the second chunk
            raise jax.errors.JaxRuntimeError("injected device fault")
        return real_run(*args, **kwargs)

    monkeypatch.setattr(solver_mod, "_run_cp", flaky_run)
    with pytest.warns(RuntimeWarning, match="injected device fault"):
        res = solver.solve(x0, max_iters=2000, tol=1e-3, chunk_iters=300)
    assert res.converged and res.num_iters == plain.num_iters
    np.testing.assert_allclose(res.xi_history, plain.xi_history, atol=1e-12)
    for a, b in zip(res.primal, plain.primal):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)

    # fault during the FIRST chunk: recovery restarts from the initial
    # iterate snapshot (taken before any device work), identical results
    calls["n"] = 0

    def flaky_first(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise jax.errors.JaxRuntimeError("injected first-chunk fault")
        return real_run(*args, **kwargs)

    monkeypatch.setattr(solver_mod, "_run_cp", flaky_first)
    with pytest.warns(RuntimeWarning, match="after iteration 0"):
        res1 = solver.solve(x0, max_iters=2000, tol=1e-3, chunk_iters=300)
    assert res1.converged and res1.num_iters == plain.num_iters
    np.testing.assert_allclose(res1.xi_history, plain.xi_history,
                               atol=1e-12)

    # persistent fault: every call after the first chunk fails
    calls["n"] = 0

    def dead_run(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise jax.errors.JaxRuntimeError("injected persistent fault")
        return real_run(*args, **kwargs)

    monkeypatch.setattr(solver_mod, "_run_cp", dead_run)
    ckpt = str(tmp_path / "fault.npz")
    with pytest.warns(RuntimeWarning, match="persistent fault"), \
            pytest.raises(RuntimeError, match="saved to"):
        solver.solve(x0, max_iters=2000, tol=1e-3, chunk_iters=300,
                     checkpoint_on_fault=ckpt)
    # the checkpoint resumes through the standard warm-start machinery
    z, eta, k = solver_mod.SolverResult.load_checkpoint(ckpt)
    assert k == 301        # a 300-chunk runs 301 reference-semantics steps
    monkeypatch.setattr(solver_mod, "_run_cp", real_run)
    resumed = solver.solve(x0, max_iters=2000, tol=1e-3,
                           warm_start=(z, eta))
    assert resumed.converged
    assert resumed.num_iters + k <= plain.num_iters + 2
