#!/usr/bin/env python
"""Run the five BASELINE.json benchmark configurations end-to-end.

For each config: build the problem, solve to 1e-3 (the BASELINE target
residual), and report iterations, wall-clock of the device loop, CP
iterations/s, and time-to-1e-3. Config 5 is the closed-loop risk-averse
MPC run (100-state plant, ~1e5-node tree); pass ``--small`` to run every
config at reduced scale (CI-sized, CPU-friendly).

Prints one JSON line per config.

  1. 2-state/1-input LQR-style RAOCP, binary tree, N=3, AVaR
  2. mass-spring chain (10 states), branching-2, horizon 6, input boxes
  3. 20-state, branching-3, horizon 7 (~3k nodes), SOC (ball) + AVaR
  4. 50-state network, ~1e4-node tree, SuperMann/Broyden-accelerated
  5. 100-state, ~1e5-node tree, closed-loop risk-averse MPC
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _solve_config(name, problem, x0, dtype, accel=None, max_iters=20000,
                  tol=1e-3, offline="device", chunk_iters=None, **solve_kw):
    """One artifact row. Every config gets a PLAIN CP row; configs that
    name an accelerated formulation additionally get the accel row, so
    plain-vs-accel is provable per config inside one artifact."""
    import jax.numpy as jnp

    from raocp_tpu.solver import Solver

    t0 = time.perf_counter()
    solver = Solver(problem, dtype=dtype, offline=offline)
    setup_s = time.perf_counter() - t0

    def one(row_name, **kw):
        # accel loops carry their own histories and do not support chunking
        if kw.get("accel") is None and chunk_iters is not None:
            kw = dict(kw, chunk_iters=chunk_iters)
        res = solver.solve(x0, max_iters=max_iters, tol=tol, **kw)
        # re-run: the first solve pays compilation; the loop is what we time
        res = solver.solve(x0, max_iters=max_iters, tol=tol, **kw)
        v = solver.validate(res)
        print(json.dumps({
            "config": row_name,
            "num_nodes": problem.tree.num_nodes,
            "converged": bool(res.converged),
            "iterations": res.num_iters,
            "iters_per_s": round(res.iters_per_second, 2),
            "time_to_tol_s": round(res.solve_time, 4),
            "setup_s": round(setup_s, 2),
            "max_violation": max(v.values()),
            "accel": kw.get("accel"),
        }), flush=True)
        return res

    res = one(name, **solve_kw)
    if accel is not None:
        one(f"{name}_{accel}", accel=accel)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CI-sized versions of every config")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--relax", default="auto",
                    help="over-relaxation for the config-5 per-step solves; "
                         "'auto' (the RiskAverseMPC default) resolves to "
                         "1.8 — no hand-set knob; pass 1.0 for "
                         "reference-parity iterations")
    args = ap.parse_args()
    which = {int(c) for c in args.configs.split(",")}

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()
    on_cpu = jax.devices()[0].platform == "cpu"
    dtype = jnp.float64 if (on_cpu and jax.config.jax_enable_x64) \
        else jnp.float32
    small = args.small

    from raocp_tpu.models import (lqr_binary_problem, mass_spring_problem,
                                  network_mpc_controller,
                                  random_network_problem,
                                  soc_network_problem)

    if 1 in which:
        problem, x0 = lqr_binary_problem(num_stages=3)
        _solve_config("1_lqr_binary_15node", problem, x0, dtype,
                      offline="host")

    if 2 in which:
        problem, x0 = mass_spring_problem(num_masses=5, num_stages=6)
        _solve_config("2_mass_spring_127node", problem, x0, dtype,
                      offline="host")

    if 3 in which:
        problem, x0 = soc_network_problem(
            num_states=20, num_inputs=8, num_modes=3,
            num_stages=4 if small else 7, stopping_time=3 if small else 7)
        _solve_config("3_soc_network_3k_node", problem, x0, dtype,
                      chunk_iters=2500)

    if 4 in which:
        problem, x0 = random_network_problem(
            num_states=50, num_inputs=20, num_modes=3,
            num_stages=4 if small else 8, stopping_time=4 if small else 8)
        _solve_config("4_network_1e4", problem, x0, dtype,
                      accel="supermann", chunk_iters=2500)

    if 5 in which:
        # closed-loop risk-averse MPC on the 100-state plant; the per-step
        # problem is a ~1e5-node tree (88,573 nodes: 3^0..3^10, fully
        # branched — a post-stopping chain at this state dim would force
        # the dense device Riccati stacks, ~10 GB peak HBM; the fully
        # branched tree keeps the stage-constant table path AND is larger)
        kw = (dict(num_states=8, num_inputs=3, num_stages=3,
                   stopping_time=2) if small else
              dict(num_states=100, num_inputs=40, num_stages=10,
                   stopping_time=10))
        controller, x0 = network_mpc_controller(
            num_modes=3, dtype=dtype,
            offline="host" if small else "device", **kw)
        t0 = time.perf_counter()
        # production loop config (check_every=25, unroll=5): per-iteration
        # reference stopping at 1e5 nodes/100 states costs ~3x per step;
        # chunk_iters bounds each device execution (ROADMAP D5 decides
        # whether it stays)
        from raocp_tpu.solver import _resolve_relax
        relax = ("auto" if args.relax == "auto" else float(args.relax))
        run = controller.run(x0, num_steps=3 if small else 5,
                             max_iters=20000, tol=1e-3,
                             check_every=1 if small else 25,
                             unroll=1 if small else 5,
                             chunk_iters=None if small else 2500,
                             relax=relax)
        wall = time.perf_counter() - t0
        print(json.dumps({
            "config": "5_mpc_closed_loop_1e5",
            "num_nodes": controller.solver_for_mode(0)[1].tree.num_nodes,
            "converged": run.converged,
            "mpc_steps": len(run.states) - 1,
            "iterations_per_step": [int(k) for k in run.iterations],
            "wall_s": round(wall, 2),
            # record the RESOLVED rho: "auto" rows must stay numerically
            # comparable across rounds even if the auto default is retuned
            "relax": _resolve_relax(relax),
            "relax_mode": "auto" if relax == "auto" else "explicit",
        }), flush=True)


if __name__ == "__main__":
    main()
