"""CPU tests of the GPU smoke run (``chip_smoke.py``) and of what it relies
on: the compile-cache helper, the compile clock, the roofline peak table,
and the full-float32 matmul precision of every solver program.

The smoke phases are functions of their sizes and devices, so each runs
here at a tiny size on the CPU backend (the multi-device phase on four of
the conftest's virtual devices). Only ``chip_smoke.main`` insists on a GPU.
"""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from raocp_tpu.core import stacked as stacked_mod
from raocp_tpu.core.stacked import build_stacked
from raocp_tpu.models import demo_problem, random_network_problem
from raocp_tpu.parallel import make_mesh
from raocp_tpu.solver import Solver, _power_iteration, _run_cp
from raocp_tpu.utils.compilation import compile_cache_dir, compile_clock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu():
    return jax.devices("cpu")[0]


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache_dir()
    assert first == compile_cache_dir()
    assert first == os.path.join(REPO, ".jax_cache")


def test_compile_clock_counts_compilation_only():
    f = jax.jit(lambda x: jnp.cumsum(x * 3.0 + 1.0))
    with compile_clock() as compiling:
        f(np.arange(7.0)).block_until_ready()
        first = compiling()
        f(np.arange(7.0)).block_until_ready()     # cached: no new span
        assert compiling() == first
    assert first > 0.0


def test_device_check_raises_on_cpu():
    with pytest.raises(RuntimeError, match="not a GPU"):
        chip_smoke.check_device(jax.devices("cpu"))


def test_operators_phase_tiny():
    out = chip_smoke.check_operators(_cpu(), _cpu(), num_states=4,
                                     num_inputs=2, num_stages=3)
    assert out["num_nodes"] == 40
    for name in ("ell", "ell_t", "prox_f", "g_conj_projections"):
        assert out[name] <= chip_smoke.OPERATOR_BOUND


def test_closed_loop_phase_tiny():
    out = chip_smoke.check_closed_loop(_cpu(), num_states=4, num_inputs=2,
                                       num_stages=3, num_steps=2)
    assert out["num_nodes"] == 40 and len(out["steps"]) == 2
    for step in out["steps"]:
        assert step["converged"] and step["iterations"] > 0
        assert step["build_s"] >= 0.0 and step["compile_s"] >= 0.0


def test_multi_device_phase_on_virtual_devices():
    out = chip_smoke.check_multi_device(
        jax.devices("cpu")[:4], num_states=4, num_inputs=2, num_stages=3,
        ragged_stages=4)
    assert out["subtree"]["partition"] == "subtree"
    assert out["flat"]["partition"] == "flat"
    for row in out.values():
        assert row["devices"] == 4
        assert row["primal_rel_diff"] <= chip_smoke.MESH_BOUND
        assert abs(row["iters_to_tol_1"] - row["iters_to_tol_n"]) <= 25


def _load_roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline", os.path.join(REPO, "scripts", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_raises_for_unknown_device_kind():
    roofline = _load_roofline()
    assert roofline.chip_peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.chip_peaks("cpu")


# -- every program on the main path traces under full-float32 products -----

def _dot_precisions(jaxpr):
    """The precision of every dot_general in a jaxpr and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else (value,)):
                if hasattr(sub, "eqns"):
                    yield from _dot_precisions(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    yield from _dot_precisions(sub.jaxpr)


def _loop_args(sp, x0):
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = x0
    a = jnp.asarray(0.1, sp.dtype)
    return (z0, sp.zero_dual(xp=np), jnp.asarray(x0, sp.dtype), a, a,
            jnp.asarray(0.0, sp.dtype))


def _trace_run_cp():
    problem, x0 = random_network_problem(num_states=3, num_inputs=2,
                                         num_stages=3, stopping_time=3)
    sp = build_stacked(problem, dtype=jnp.float32)
    return _run_cp.trace(sp, *_loop_args(sp, x0), 4, check_every=2,
                         unroll=2).jaxpr


def _trace_power_iteration():
    problem, _ = random_network_problem(num_states=3, num_inputs=2,
                                        num_stages=3, stopping_time=3)
    return _power_iteration.trace(
        build_stacked(problem, dtype=jnp.float32)).jaxpr


def _trace_riccati_device(monkeypatch):
    calls = []
    real = stacked_mod._riccati_device_jit

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(stacked_mod, "_riccati_device_jit", record)
    problem, _ = demo_problem(num_stages=3, stopping_time=3)   # ragged
    build_stacked(problem, dtype=jnp.float32, offline="device")
    assert calls, "the ragged demo tree should run the device Riccati"
    args, kwargs = calls[0]
    return real.trace(*args, **kwargs).jaxpr


def _trace_subtree_run_cp():
    problem, x0 = random_network_problem(num_states=3, num_inputs=2,
                                         num_stages=3, stopping_time=3)
    solver = Solver(problem, dtype=jnp.float32, mesh=make_mesh(
        num_devices=2))
    stp = solver.subtree
    z0 = stp.zero_primal_global_layout()
    z0.x[::stp.l_np] = x0
    _, eta0, x0j, a1, a2, tol = _loop_args(solver.stacked, x0)
    eta0 = stp.zero_dual_global_layout()
    return jax.make_jaxpr(partial(stp.run_cp, max_iters=4, check_every=2,
                                  unroll=2))(z0, eta0, x0j, a1, a2, tol).jaxpr


@pytest.mark.parametrize("program", ["run_cp", "power_iteration",
                                     "riccati_device", "subtree_run_cp"])
def test_main_path_traces_full_float32_products(program, monkeypatch):
    """Unless told otherwise a GPU may run float32 products in TF32; every
    solver program must pin them to full float32 (HIGHEST)."""
    jaxpr = {"run_cp": _trace_run_cp,
             "power_iteration": _trace_power_iteration,
             "riccati_device": partial(_trace_riccati_device, monkeypatch),
             "subtree_run_cp": _trace_subtree_run_cp}[program]()
    precisions = list(_dot_precisions(jaxpr))
    assert precisions, "no matrix products traced"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)
