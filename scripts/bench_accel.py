#!/usr/bin/env python
"""Accelerated vs plain CP: time-to-1e-3 across PROBLEM SIZES.

BASELINE config 4 names "SuperMann/L-BFGS accelerated iterations"; the
round-4 verdict asked where (if anywhere) acceleration actually wins. The
bandwidth accounting says the win region must be SMALL problems: each
accel history row is a full extended vector, so the direction apply +
quasi-Newton push add ~2 x memory full-iterate passes per step — ruinous
where the iteration is HBM-bound (1e4+ nodes), nearly free where it is
dispatch-latency-bound (<= ~1e3 nodes, where per-iteration wall time is
kernel-launch overhead, not bytes). An iteration cut then converts ~1:1
into wall-clock. This sweep measures plain CP (production stride), the
zero-cost relax=1.8 cutter, Anderson(m5), and SuperMann/Broyden(m5, the
round-5 not-worse line-search defaults) on the four solve-config sizes.

Prints one JSON line per (config, method).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOL = 1e-3
REPEATS = 3


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.accel import run_cp_anderson, run_cp_supermann
    from raocp_tpu.models import (lqr_binary_problem, mass_spring_problem,
                                  random_network_problem,
                                  soc_network_problem)
    from raocp_tpu.solver import Solver, _run_cp

    configs = [
        ("1_lqr_binary_15node", 6000, lambda: lqr_binary_problem(
            num_stages=3)),
        ("2_mass_spring_127node", 6000, lambda: mass_spring_problem(
            num_masses=5, num_stages=6)),
        ("3_soc_network_3k_node", 20000, lambda: soc_network_problem(
            num_states=20, num_inputs=8, num_modes=3, num_stages=7,
            stopping_time=7)),
        ("4_network_1e4", 20000, lambda: random_network_problem(
            num_states=50, num_inputs=20, num_modes=3, num_stages=8,
            stopping_time=8)),
    ]

    for name, max_iters, make in configs:
        problem, x0 = make()
        solver = Solver(problem, dtype=jnp.float32, offline="device")
        sp = solver.stacked
        alpha = jnp.asarray(0.999 / solver.operator_norm_sq(), sp.dtype)
        x0j = jnp.asarray(np.asarray(x0, dtype=np.float64), sp.dtype)
        tol = jnp.asarray(TOL, sp.dtype)
        z0 = sp.zero_primal(xp=np)
        z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
        eta0 = sp.zero_dual(xp=np)

        def timed(method, fn, **extra):
            out = fn()                   # compile + converge once
            jax.block_until_ready(out)
            best = float("inf")
            for _ in range(REPEATS):
                tic = time.perf_counter()
                out = fn()
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - tic)
            iters = int(out[2])
            err = np.asarray(out[-2])
            if len(out) == 6:            # accel loops report T evaluations
                extra["t_evals"] = int(out[3])
            rec = {
                "config": name,
                "num_nodes": problem.tree.num_nodes,
                "run": method,
                "iterations": iters,
                "converged": bool(err.max() <= TOL),
                "time_to_tol_s": round(best, 4),
                "iters_per_s": round(iters / best, 1),
                "xi_max": float(err.max()),
            }
            rec.update(extra)
            print(json.dumps(rec), flush=True)

        timed("plain_check25_unroll25",
              lambda: _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol,
                              max_iters, check_every=25, unroll=25))
        timed("relax1.8_check25_unroll25",
              lambda: _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol,
                              max_iters, check_every=25, unroll=25,
                              relax=1.8), relax=1.8)
        timed("anderson_m5_check25",
              lambda: run_cp_anderson(sp, tuple(z0), tuple(eta0), x0j,
                                      alpha, tol, max_iters, memory=5,
                                      check_every=25), memory=5)
        timed("supermann_m5_check25",
              lambda: run_cp_supermann(sp, tuple(z0), tuple(eta0), x0j,
                                       alpha, tol, max_iters, memory=5,
                                       check_every=25), memory=5)


if __name__ == "__main__":
    main()
