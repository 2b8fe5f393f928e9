#!/usr/bin/env python
"""Per-component device timing of the CP iteration on the benchmark problem.

Times each piece of one Chambolle-Pock step (L, L', prox_f sweeps, dual
projections, residual norms) by running it inside a jitted ``fori_loop``
with a data dependency between iterations, so XLA cannot elide or overlap
across trips. Used to decide where optimisation effort goes; not part of
the headline bench.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _time(fn, *args, iters=200):
    """Time fn inside a fori_loop; a scalar from the output is folded back
    into the carry so trips are serialised without changing shapes."""
    @jax.jit
    def loop(*args):
        def body(_, a):
            out = fn(*a)
            dep = sum(jnp.sum(l.ravel()[:1])
                      for l in jax.tree_util.tree_leaves(out))
            dep = 1e-30 * dep    # not 0.0: XLA would fold it and DCE fn
            return jax.tree_util.tree_map(lambda x: x + dep, a)
        return jax.lax.fori_loop(0, iters, body, args)

    out = loop(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        tic = time.perf_counter()
        jax.block_until_ready(loop(*args))
        best = min(best, time.perf_counter() - tic)
    return best / iters * 1e6  # us


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--states", type=int, default=50)
    ap.add_argument("--inputs", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()
    # the solver's own matmul precision (full float32, no TF32/bf16)
    jax.config.update("jax_default_matmul_precision", "float32")

    from raocp_tpu.models import random_network_problem
    from raocp_tpu.ops.operator import ell, ell_t
    from raocp_tpu.ops.prox import (g_conj_projections, project_dynamics,
                                    project_kernel, prox_f)
    from raocp_tpu.solver import Solver, cp_iteration

    problem, x0 = random_network_problem(
        num_states=args.states, num_inputs=args.inputs, num_modes=3,
        num_stages=args.stages, stopping_time=args.stages)
    solver = Solver(problem, dtype=jnp.float32, offline="device")
    sp = solver.stacked

    x0j = jnp.asarray(x0, sp.dtype)
    key = jax.random.PRNGKey(0)
    z = sp.zero_primal()
    z = z._replace(
        x=jax.random.normal(key, z.x.shape, sp.dtype),
        u=jax.random.normal(key, z.u.shape, sp.dtype))
    eta = ell(sp, z)
    alpha = jnp.asarray(0.01, sp.dtype)

    it = args.iters
    t_noop = _time(lambda v: (v,), z.x, iters=it)
    t_ell = _time(lambda z: (ell(sp, z),), z, iters=it)
    t_ellt = _time(lambda e: (ell_t(sp, e),), eta, iters=it)
    t_dyn = _time(lambda x, u: project_dynamics(sp, x, u, x0j), z.x, z.u,
                  iters=it)
    t_ker = _time(lambda y, t, s: project_kernel(sp, y, t, s),
                  z.y, z.tau, z.s, iters=it)
    t_pf = _time(lambda zz: (prox_f(sp, zz, alpha, x0j),), z, iters=it)
    t_gp = _time(lambda e: (g_conj_projections(sp, e),), eta, iters=it)
    t_norm = _time(lambda v: (jnp.max(jnp.abs(v)) * v,), z.x, iters=it)

    def full(z, eta, Lz, Lt):
        return cp_iteration(sp, z, eta, Lz, Lt, alpha, alpha, x0j)[:4]

    t_full = _time(full, z, eta, ell(sp, z), ell_t(sp, eta), iters=it)

    def step_only(z, eta, Lz, Lt):
        from raocp_tpu.solver import _cp_step
        return _cp_step(sp, z, eta, Lz, Lt, alpha, alpha, x0j)

    t_step = _time(step_only, z, eta, ell(sp, z), ell_t(sp, eta), iters=it)

    dev = jax.devices()[0]
    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "num_nodes": sp.num_nodes, "n": sp.n, "m": sp.m, "unit": "us",
        "noop": t_noop, "ell": t_ell, "ell_t": t_ellt,
        "project_dynamics": t_dyn, "project_kernel": t_ker,
        "prox_f": t_pf, "g_conj_projections": t_gp, "max_norm": t_norm,
        "cp_step": t_step, "cp_iteration": t_full}))


if __name__ == "__main__":
    main()
