#!/usr/bin/env python
"""bf16-storage experiment (VERDICT r4 #5): store the read-only numeric
tables of the hot loop — mode blocks, stage-stacked contraction blocks,
Riccati tables, kernel projectors — in bfloat16 (f32 accumulation via
mixed-dtype promotion; XLA reads bf16 from HBM and converts in-register),
and measure BOTH the iterations/s delta and the convergence impact.

Context from the roofline (DESIGN §9): the iteration is bandwidth-bound at
~318 us, so bytes are the lever. But on stage-constant / mode-interned
trees the tables this can halve are O(modes x stages) — a few hundred KB
against ~16 MB of iterate traffic per pass — so the predicted ceiling is
small; and the Riccati tables define the prox_f PROJECTION, whose bf16
perturbation (~0.4% relative) makes the projection inconsistent with the
exact L operator, which CP theory says stalls the residuals near that
error level. This script measures both effects instead of guessing.

Prints one JSON line per (config, variant).
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# read-only matmul/einsum operand tables of the hot loop; EXCLUDES bounds,
# masks and b_pad (comparison / constraint data where rounding changes the
# feasible set rather than the arithmetic)
_TABLE_FIELDS = ("Pi", "P", "Rinv", "K", "Abar", "sumAPB")
_TABLE_MODAL = ("Am", "Bm", "ABm", "sqrtQ", "sqrtR", "QRm", "sqrtP")
_TABLE_STAGE = ("ab_fwd", "ab_bwd", "qr_fwd", "qr_bwd", "k_s", "rinv_s",
                "sumapb_s", "k_ms", "rinv_ms", "sumapb_ms")


def cast_tables(sp, dtype):
    import jax.numpy as jnp

    def cast(a):
        return None if a is None else jnp.asarray(a, dtype)

    updates = {}
    bytes_saved = 0
    for name in _TABLE_FIELDS:
        a = getattr(sp, name)
        if a is not None:
            updates[name] = cast(a)
            bytes_saved += a.size * (a.dtype.itemsize - 2)
    for name in _TABLE_MODAL:
        mm = getattr(sp, name)
        if mm is None:
            continue
        for part in ("dense_m", "modes"):
            a = getattr(mm, part)
            if a is not None:
                bytes_saved += a.size * (a.dtype.itemsize - 2)
        updates[name] = dataclasses.replace(
            mm, dense_m=cast(mm.dense_m), modes=cast(mm.modes))
    for name in _TABLE_STAGE:
        tab = getattr(sp, name)
        out = []
        for a in tab:
            if a is not None:
                bytes_saved += a.size * (a.dtype.itemsize - 2)
            out.append(cast(a))
        updates[name] = tuple(out)
    return dataclasses.replace(sp, **updates), bytes_saved


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.core.stacked import build_stacked
    from raocp_tpu.models import (demo_problem, random_network_problem,
                                  soc_network_problem)
    from raocp_tpu.solver import _power_iteration, _run_cp

    def run(name, problem, x0, iters, tol, repeats=3):
        sp0 = build_stacked(problem, dtype=jnp.float32, offline="device")
        for variant in ("f32", "bf16-tables"):
            if variant == "f32":
                sp, saved = sp0, 0
            else:
                sp, saved = cast_tables(sp0, jnp.bfloat16)
            lam, _ = _power_iteration(sp0)     # step size from exact tables
            alpha = jnp.asarray(0.999 / float(lam), jnp.float32)
            z0 = sp.zero_primal(xp=np)
            z0.x[0] = np.asarray(x0, z0.x.dtype)
            eta0 = sp.zero_dual(xp=np)
            args = (sp, tuple(z0), tuple(eta0),
                    jnp.asarray(x0, jnp.float32), alpha, alpha,
                    jnp.asarray(tol, jnp.float32))
            out = _run_cp(*args, iters, check_every=25, unroll=25)
            jax.block_until_ready(out)
            best = float("inf")
            for _ in range(repeats):
                tic = time.perf_counter()
                out = _run_cp(*args, iters, check_every=25, unroll=25)
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - tic)
            it = int(out[2])
            err = np.asarray(out[3], dtype=np.float64)
            print(json.dumps({
                "config": name, "variant": variant,
                "table_bytes_saved_mb": round(saved / 1e6, 2),
                "iters_run": it,
                "iters_per_s": round(it / best, 1),
                "final_xi": [float(f"{v:.3e}") for v in err],
                "converged_to_tol": bool(err.max() <= tol),
            }), flush=True)

    # throughput at the headline scale (tol 0: fixed 2000 iterations)
    problem, x0 = random_network_problem(
        num_states=50, num_inputs=20, num_modes=3, num_stages=8,
        stopping_time=8)
    run("headline_9841node_throughput", problem, x0, 2000, 0.0)

    # convergence probes: does bf16 table storage still reach 1e-3?
    problem, x0 = demo_problem()
    run("demo_32node_tol1e-3", problem, x0, 5000, 1e-3, repeats=1)
    problem, x0 = soc_network_problem(
        num_states=20, num_inputs=8, num_modes=3, num_stages=7,
        stopping_time=7)
    run("soc_3k_tol1e-3", problem, x0, 10000, 1e-3, repeats=1)


if __name__ == "__main__":
    main()
