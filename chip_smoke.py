#!/usr/bin/env python
"""Smoke run of the solver on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: every phase below but the last
    python chip_smoke.py --four   # four GPUs: the multi-device phase only

Drives the main path through the entry points a user calls (``Solver``,
``RiskAverseMPC``) at the repository's real widths, and checks each result:

* device: JAX's default device is a GPU. There is no CPU fallback.
* parity: the reference demo in float64 takes exactly 937 iterations.
* operators: L, L', prox_f and the g* projections in float32 on the GPU
  against float64 on the CPU backend, 9,841 nodes / 50 states, within
  1e-5 relative (TF32 products would miss that by two orders).
* headline: the 9,841-node / 50-state problem solved to 1e-3 in float32,
  and ``Solver.validate`` within 1e-3.
* closed_loop: two closed-loop MPC steps on the 88,573-node / 100-state
  tree, each converged.
* multi_device (``--four``): the subtree partition on the closed-loop tree
  and the flat partition on a ragged 10,251-node tree, each against a
  one-GPU solve of the same problem in the same process.

Each phase prints one JSON line with the card's name and power limit. The
times are smoke numbers, not benchmark numbers. A failed check raises, so
the script exits non-zero. On success the last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The phases are functions of their sizes and devices; the CPU tests call
them at tiny sizes.
"""

import argparse
import json
import os
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

import raocp_tpu
from raocp_tpu.models import (demo_problem, network_mpc_controller,
                              random_network_problem)
from raocp_tpu.ops.operator import ell, ell_t
from raocp_tpu.ops.prox import g_conj_projections, prox_f
from raocp_tpu.parallel import make_mesh
from raocp_tpu.solver import Solver, _power_iteration, _with_matmul_precision
from raocp_tpu.utils.compilation import compile_clock, enable_compile_cache

# the reference's committed experiment (tests/test_solver.py)
PARITY_ITERS = 937
PARITY_XI = (9.9508e-4, 9.4106e-4, 9.5599e-4)
# full-float32 products land near 1e-7 relative; TF32 near 1e-3
OPERATOR_BOUND = 1e-5
# 500 float32 iterations of a nonexpansive map: each step can add a few
# ulps (~1e-7) of summation-order difference between one device and a
# mesh's partial sums plus all-reduce, and the map does not amplify them,
# so the iterates may drift apart by about 500 x 1e-7 = 5e-5 relative
MESH_ITERS = 500
MESH_BOUND = 1e-4


def gpu_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def check_device(devices) -> dict:
    """Raise unless the first device is a GPU."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"JAX's default device is {dev.platform} ({dev.device_kind}), "
            "not a GPU; this smoke run has no CPU fallback")
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(devices), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def check_parity(device) -> dict:
    """The reference demo in float64: exactly 937 iterations."""
    if not jax.config.jax_enable_x64:
        raise RuntimeError("the parity phase needs jax_enable_x64")
    with jax.default_device(device):
        problem, x0 = demo_problem()
        solver = Solver(problem, dtype=jnp.float64)
        with compile_clock() as compiling:
            res = solver.solve(x0, max_iters=2000, tol=1e-3)
    if res.num_iters != PARITY_ITERS or not np.allclose(
            res.xi, PARITY_XI, rtol=1e-3):
        raise RuntimeError(
            f"demo took {res.num_iters} iterations, xi={res.xi.tolist()}; "
            f"expected {PARITY_ITERS}, xi={list(PARITY_XI)}")
    return {"iterations": res.num_iters, "xi": res.xi.tolist(),
            "compile_s": compiling(), "solve_s": res.solve_time}


def _random_iterates(sp, rng):
    """A random (primal, dual) pair of host float32 arrays."""
    z = sp.zero_primal(xp=np)
    eta = sp.zero_dual(xp=np)

    def fill(v):
        return rng.standard_normal(v.shape).astype(np.float32)

    return (type(z)(*map(fill, z)), type(eta)(*map(fill, eta)))


def check_operators(device, ref_device, num_states=50, num_inputs=20,
                    num_stages=8, seed=0) -> dict:
    """L, L', prox_f and the g* projections in float32 on ``device``
    against float64 on ``ref_device``, on the same inputs."""
    problem, x0 = random_network_problem(
        num_states=num_states, num_inputs=num_inputs, num_modes=3,
        num_stages=num_stages, stopping_time=num_stages, seed=seed)
    with jax.default_device(device):
        sp = Solver(problem, dtype=jnp.float32, offline="device").stacked
    with jax.default_device(ref_device):
        sp_ref = Solver(problem, dtype=jnp.float64).stacked
    if (sp.np_pad, sp.nl_pad) != (sp_ref.np_pad, sp_ref.nl_pad):
        raise RuntimeError("float32 and float64 layouts differ")
    z, eta = _random_iterates(sp, np.random.default_rng(seed))
    alpha = 0.5

    ops = {
        "ell": lambda sp, z, eta, x0: ell(sp, z),
        "ell_t": lambda sp, z, eta, x0: ell_t(sp, eta),
        "prox_f": lambda sp, z, eta, x0: prox_f(sp, z, alpha, x0),
        "g_conj_projections":
            lambda sp, z, eta, x0: g_conj_projections(sp, eta),
    }
    out = {"num_nodes": sp.num_nodes, "num_states": sp.n}
    for name, op in ops.items():
        fn = jax.jit(_with_matmul_precision(op))
        with jax.default_device(device):
            got = fn(sp, z, eta, jnp.asarray(x0, jnp.float32))
        with jax.default_device(ref_device):
            want = fn(sp_ref, _cast(z, np.float64), _cast(eta, np.float64),
                      jnp.asarray(x0, jnp.float64))
        got = [np.asarray(v, np.float64) for v in jax.tree.leaves(got)]
        want = [np.asarray(v) for v in jax.tree.leaves(want)]
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        scale = max(float(np.abs(w).max()) for w in want)
        rel = err / scale
        out[name] = rel
        if not rel <= OPERATOR_BOUND:
            raise RuntimeError(
                f"{name}: max|gpu - ref| / max|ref| = {rel:.3e} exceeds "
                f"{OPERATOR_BOUND:.0e}")
    return out


def _cast(tree, dtype):
    """Every leaf of a pytree of host arrays, cast to ``dtype``."""
    return jax.tree.map(lambda v: np.asarray(v, dtype), tree)


def check_headline(device, num_states=50, num_inputs=20, num_stages=8,
                   tol=1e-3, check_every=25, unroll=25) -> dict:
    """The headline problem solved to ``tol`` in float32."""
    problem, x0 = random_network_problem(
        num_states=num_states, num_inputs=num_inputs, num_modes=3,
        num_stages=num_stages, stopping_time=num_stages)
    with jax.default_device(device):
        tic = time.perf_counter()
        solver = Solver(problem, dtype=jnp.float32, offline="device")
        build_s = time.perf_counter() - tic
        _, power_iters = _power_iteration(solver.stacked)
        with compile_clock() as compiling:
            res = solver.solve(x0, max_iters=20000, tol=tol,
                               check_every=check_every, unroll=unroll)
        compile_s = compiling()
    checks = solver.validate(res)
    if not res.converged:
        raise RuntimeError(f"headline solve did not converge: xi={res.xi}")
    if max(checks.values()) > tol:
        raise RuntimeError(f"headline solution violates {checks}")
    solve_s = res.solve_time - compile_s
    return {"num_nodes": solver.stacked.num_nodes, "num_states": num_states,
            "iterations": res.num_iters, "xi": res.xi.tolist(),
            "power_iterations": int(power_iters), "validate": checks,
            "build_s": build_s, "compile_s": compile_s, "solve_s": solve_s,
            "iters_per_s": res.num_iters / solve_s}


def check_closed_loop(device, num_states=100, num_inputs=40, num_stages=10,
                      num_steps=2, check_every=25, unroll=5) -> dict:
    """``num_steps`` closed-loop MPC steps, every one converged."""
    with jax.default_device(device):
        controller, x0 = network_mpc_controller(
            num_states=num_states, num_inputs=num_inputs,
            num_stages=num_stages, stopping_time=num_stages, num_modes=3,
            dtype=jnp.float32, offline="device")
        run = controller.run(x0, num_steps=num_steps, max_iters=20000,
                             tol=1e-3, check_every=check_every,
                             unroll=unroll, relax="auto")
    steps = [{"mode": int(run.modes[t]), "iterations": int(run.iterations[t]),
              "converged": bool(run.statuses[t] == 0),
              "build_s": float(run.build_times[t]),
              "compile_s": float(run.compile_times[t]),
              "solve_s": float(run.solve_times[t] - run.compile_times[t])}
             for t in range(run.num_steps)]
    if not run.converged:
        raise RuntimeError(f"a closed-loop step did not converge: {steps}")
    if not (np.isfinite(run.states).all() and np.isfinite(run.inputs).all()):
        raise RuntimeError("closed-loop trajectory is not finite")
    tree = controller.solver_for_mode(int(run.modes[0]))[1].tree
    return {"num_nodes": tree.num_nodes, "num_states": num_states,
            "steps": steps}


def _primal_rows(res, num_nodes, num_nonleaf):
    """The real rows of a result's primal, layout padding dropped."""
    p = res.primal
    return [np.asarray(p.x)[:num_nodes], np.asarray(p.u)[:num_nonleaf],
            np.asarray(p.y)[:num_nonleaf], np.asarray(p.tau)[:num_nodes],
            np.asarray(p.s)[:num_nodes]]


def _compare_partition(problem, x0, devices, partition, offline,
                       check_every, unroll) -> dict:
    """One problem on one device and on a mesh over ``devices``."""
    tree = problem.tree
    mesh = make_mesh(devices)
    with jax.default_device(devices[0]):
        one = Solver(problem, dtype=jnp.float32, offline=offline)
    many = Solver(problem, dtype=jnp.float32, offline=offline, mesh=mesh,
                  partition=partition)
    engaged = "subtree" if many.subtree is not None else "flat"
    if engaged != partition:
        raise RuntimeError(f"asked for {partition}, got {engaged}")
    kw = dict(check_every=check_every, unroll=unroll)
    with jax.default_device(devices[0]):
        r1 = one.solve(x0, max_iters=MESH_ITERS, tol=0.0, **kw)
    rn = many.solve(x0, max_iters=MESH_ITERS, tol=0.0, **kw)
    a = _primal_rows(r1, tree.num_nodes, tree.num_nonleaf_nodes)
    b = _primal_rows(rn, tree.num_nodes, tree.num_nonleaf_nodes)
    rel = (max(float(np.abs(u - v).max()) for u, v in zip(a, b))
           / max(float(np.abs(u).max()) for u in a))
    with jax.default_device(devices[0]):
        s1 = one.solve(x0, max_iters=20000, tol=1e-3, relax="auto", **kw)
    sn = many.solve(x0, max_iters=20000, tol=1e-3, relax="auto", **kw)
    out = {"partition": partition, "num_nodes": tree.num_nodes,
           "num_states": one.stacked.n, "devices": len(devices),
           "iterations": MESH_ITERS, "primal_rel_diff": rel,
           "iters_to_tol_1": s1.num_iters, "iters_to_tol_n": sn.num_iters,
           "solve_s_1": s1.solve_time, "solve_s_n": sn.solve_time}
    if not rel <= MESH_BOUND:
        raise RuntimeError(f"{partition}: primal iterates differ by {rel:.3e}"
                           f" relative after {MESH_ITERS} iterations")
    if not (s1.converged and sn.converged
            and abs(s1.num_iters - sn.num_iters) <= check_every):
        raise RuntimeError(f"{partition}: solves to 1e-3 disagree: {out}")
    return out


def check_multi_device(devices, num_states=100, num_inputs=40,
                       num_stages=10, ragged_stages=10, check_every=25,
                       unroll=5) -> dict:
    """The subtree partition on the closed-loop plant and tree, and the
    flat partition on the ragged demo tree, each against one device."""
    problem, x0 = random_network_problem(
        num_states=num_states, num_inputs=num_inputs, num_modes=3,
        num_stages=num_stages, stopping_time=num_stages)
    subtree = _compare_partition(problem, x0, devices, "subtree", "device",
                                 check_every, unroll)
    problem, x0 = demo_problem(num_stages=ragged_stages,
                               stopping_time=ragged_stages)
    flat = _compare_partition(problem, x0, devices, "flat", "host",
                              check_every, unroll)
    return {"subtree": subtree, "flat": flat}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device phase, on four GPUs")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.abspath(raocp_tpu.__file__).startswith(here + os.sep):
        raise RuntimeError(f"raocp_tpu imported from {raocp_tpu.__file__}, "
                           f"not from this checkout ({here})")
    jax.config.update("jax_enable_x64", True)   # parity and the reference
    enable_compile_cache()

    devices = jax.devices()
    info = check_device(devices)
    card = gpu_name_and_power()
    print(f"nvidia-smi name, power.limit: {card}", flush=True)
    gpu = devices[0]
    if args.four:
        if len(devices) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        phases = [("multi_device", lambda: check_multi_device(devices))]
    else:
        cpu = jax.devices("cpu")[0]
        phases = [("parity", lambda: check_parity(gpu)),
                  ("operators", lambda: check_operators(gpu, cpu)),
                  ("headline", lambda: check_headline(gpu)),
                  ("closed_loop", lambda: check_closed_loop(gpu))]

    def emit(phase, fields):
        print(json.dumps({"phase": phase, **fields, "card": card,
                          "note": "smoke numbers, not benchmark numbers"}),
              flush=True)

    emit("device", info)
    for name, run in phases:
        tic = time.perf_counter()
        fields = run()
        fields["phase_s"] = time.perf_counter() - tic
        fields["peak_bytes_in_use"] = max(
            d.memory_stats()["peak_bytes_in_use"] for d in devices)
        emit(name, fields)
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
