#!/usr/bin/env python
"""Over-relaxation / adaptive step-balancing sweep on BASELINE configs 2-4.

Validates (or refutes) the solver.py claim that relax~1.8 cuts the
iteration count by ~1/3 at no per-step cost, on real hardware, and picks
the production bench configuration. relax is a STATIC jit arg (each value
recompiles the loop), so this sweeps two values + adaptive, not a grid.

Prints one JSON line per (config, setting).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAX_ITERS = 20000
TOL = 1e-3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="2,3,4")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    which = {int(c) for c in args.configs.split(",")}

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.models import (mass_spring_problem,
                                  random_network_problem,
                                  soc_network_problem)
    from raocp_tpu.solver import Solver, _run_cp

    on_cpu = jax.devices()[0].platform == "cpu"
    dtype = jnp.float64 if (on_cpu and jax.config.jax_enable_x64) \
        else jnp.float32

    problems = {}
    if 2 in which:
        problems["2_mass_spring_127node"] = mass_spring_problem(
            num_masses=5, num_stages=6)
    if 3 in which:
        problems["3_soc_network_3k_node"] = soc_network_problem(
            num_states=20, num_inputs=8, num_modes=3, num_stages=7,
            stopping_time=7)
    if 4 in which:
        problems["4_network_1e4_node"] = random_network_problem(
            num_states=50, num_inputs=20, num_modes=3, num_stages=8,
            stopping_time=8)

    for name, (problem, x0) in problems.items():
        solver = Solver(problem, dtype=dtype,
                        offline="host" if "127" in name else "device")
        sp = solver.stacked
        alpha = jnp.asarray(0.999 / solver.operator_norm_sq(), sp.dtype)
        x0j = jnp.asarray(np.asarray(x0, dtype=np.float64), sp.dtype)
        tol = jnp.asarray(TOL, sp.dtype)
        z0 = sp.zero_primal(xp=np)
        z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
        eta0 = sp.zero_dual(xp=np)

        def timed(setting, relax, adaptive):
            def run():
                return _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol,
                               MAX_ITERS, check_every=25, unroll=25,
                               adaptive=adaptive, relax=relax)

            out = run()
            jax.block_until_ready(out)
            best = float("inf")
            for _ in range(args.repeats):
                tic = time.perf_counter()
                out = run()
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - tic)
            iters = int(out[2])
            err = np.asarray(out[3])
            print(json.dumps({
                "config": name, "setting": setting,
                "iterations": iters,
                "converged": bool(err.max() <= TOL),
                "time_to_tol_s": round(best, 4),
                "iters_per_s": round(iters / best, 1),
            }), flush=True)

        timed("relax1.0", 1.0, False)
        timed("relax1.5", 1.5, False)
        timed("relax1.8", 1.8, False)
        timed("adaptive", 1.0, True)
        timed("relax1.8+adaptive", 1.8, True)


if __name__ == "__main__":
    main()
