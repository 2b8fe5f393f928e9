#!/usr/bin/env python
"""Sweep loop-control configs (check_every, unroll) on the headline bench
problem and print iter/s for each — used to pick bench.py's production
configuration on the device."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.models import random_network_problem
    from raocp_tpu.solver import Solver, _power_iteration, _run_cp

    problem, x0 = random_network_problem(
        num_states=50, num_inputs=20, num_modes=3, num_stages=8,
        stopping_time=8)
    solver = Solver(problem, dtype=jnp.float32, offline="device")
    sp = solver.stacked
    lam, _ = _power_iteration(sp)
    alpha = jnp.asarray(0.999 / float(lam), sp.dtype)
    x0j = jnp.asarray(x0, sp.dtype)
    tol0 = jnp.asarray(0.0, sp.dtype)
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
    eta0 = sp.zero_dual(xp=np)

    iters = 200
    configs = [(25, 1), (25, 5), (25, 25), (50, 10), (100, 20)]
    for ce, un in configs:
        t_c0 = time.perf_counter()
        out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, iters,
                      check_every=ce, unroll=un)
        jax.block_until_ready(out)
        t_compile = time.perf_counter() - t_c0
        best = float("inf")
        for _ in range(3):
            tic = time.perf_counter()
            out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0,
                          iters, check_every=ce, unroll=un)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - tic)
        n = int(out[2])
        print(f"check_every={ce:3d} unroll={un:3d}  "
              f"{n / best:8.1f} iter/s   (warm+compile {t_compile:.1f}s)",
              flush=True)


if __name__ == "__main__":
    main()
