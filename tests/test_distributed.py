"""Two-process jax.distributed test (SURVEY §5 'distributed communication
backend').

Spawns two fresh Python processes, each with 2 virtual CPU devices, joined
via ``initialize_distributed`` on a localhost coordinator — the CPU
analogue of a 2-host cluster (cross-process collectives ride Gloo instead
of NCCL). Each process shards the demo problem over the 4-device GLOBAL
mesh and runs sharded operator applies plus the full CP loop; both
processes must agree with each other and with a single-process reference
computed here.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_solve_loop():
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "distributed_worker.py")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # both processes computed the same global values (replicated outputs)
    for key in ("iters", "err", "hist_sum", "op_norm", "adj_norm",
                "subtree_err", "subtree_hist_sum"):
        np.testing.assert_allclose(outs[0][key], outs[1][key], rtol=1e-12,
                                   err_msg=key)

    # single-process reference (this pytest process: 8 virtual devices, but
    # the computation below is unsharded — same math, same pad_multiple)
    import jax
    import jax.numpy as jnp

    from raocp_tpu.core.stacked import build_stacked
    from raocp_tpu.core.variables import tree_inf_norm
    from raocp_tpu.models import demo_problem
    from raocp_tpu.ops.operator import ell, ell_t
    from raocp_tpu.solver import _run_cp

    problem, x0 = demo_problem()
    sp = build_stacked(problem, pad_multiple=4)
    z1 = sp.zero_primal(xp=np)
    z1.x[:] = np.linspace(-1.0, 1.0, z1.x.size).reshape(z1.x.shape)
    op_norm = float(jax.jit(lambda z: tree_inf_norm(ell(sp, z)))(z1))
    eta1 = sp.zero_dual(xp=np)
    eta1.e3[:] = 0.5
    adj_norm = float(jax.jit(
        lambda e: tree_inf_norm(ell_t(sp, e)))(eta1))
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
    eta0 = sp.zero_dual(xp=np)
    alpha = jnp.asarray(0.2, sp.dtype)
    out = _run_cp(sp, tuple(z0), tuple(eta0), jnp.asarray(x0, sp.dtype),
                  alpha, alpha, jnp.asarray(0.0, sp.dtype), max_iters=30)
    _, _, iters, err, hist = out

    assert outs[0]["iters"] == int(iters)
    np.testing.assert_allclose(outs[0]["err"], np.asarray(err), atol=1e-12)
    np.testing.assert_allclose(outs[0]["hist_sum"],
                               float(np.nansum(np.asarray(hist))),
                               rtol=1e-10)
    np.testing.assert_allclose(outs[0]["op_norm"], op_norm, rtol=1e-12)
    np.testing.assert_allclose(outs[0]["adj_norm"], adj_norm, rtol=1e-12)
    # the subtree-partition loop under the 2-process mesh (frontier psums
    # over Gloo) agrees with the single-process residuals
    np.testing.assert_allclose(outs[0]["subtree_err"], np.asarray(err),
                               atol=1e-10)
    np.testing.assert_allclose(outs[0]["subtree_hist_sum"],
                               float(np.nansum(np.asarray(hist))),
                               rtol=1e-9)
