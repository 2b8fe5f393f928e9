"""Chambolle-Pock solver for RAOCPs, fully on-device.

Parity: reference ``raocp/core/solver.py:12`` (``Solver.chock``). The whole
iteration — both half-steps, both prox maps, and the three residual vectors
xi_0/xi_1/xi_2 (``solver.py:63-95``) — runs as ONE jitted step inside
``jax.lax.while_loop``; the only host crossings are the final results.

Two structural improvements over the reference (same math, same iterates):

* Step size: the reference estimates lambda_max(L'L) with scipy Arnoldi
  ``eigs`` (``solver.py:109-118``); here an on-device power iteration on the
  same operator pair (tight relative tolerance, so alpha — and therefore the
  iteration count — matches).
* Operator-apply reuse: the reference applies L/L' five times per iteration
  (2 for the steps + 3 for residuals). Since L is linear and L z_k, L'eta_k
  are carried between iterations, the identical quantities here cost three
  applies: L z+, L'eta+, and L'(xi_2).
"""

import dataclasses
import os
import time
import warnings
from functools import partial, wraps
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from raocp_tpu.core.spec import RAOCP
from raocp_tpu.core.stacked import StackedProblem, build_stacked
from raocp_tpu.core.variables import (Dual, Primal, tree_add, tree_dot,
                                      tree_inf_norm, tree_sub)
from raocp_tpu.ops.operator import ell, ell_t
from raocp_tpu.ops.prox import (g_conj_projections, half_shift_dual,
                                prox_f, prox_g_conj)

__all__ = ["Solver", "SolverResult", "cp_iteration"]


@dataclasses.dataclass
class SolverResult:
    """Outcome of one Chambolle-Pock solve."""
    status: int                 # 0 = converged, 1 = max iterations reached
    num_iters: int              # CP steps executed
    xi: np.ndarray              # final [xi_0, xi_1, xi_2]
    xi_history: np.ndarray      # [num_iters, 3]
    delta_history: np.ndarray   # [num_iters, 3]
    alpha: float                # primal/dual step size used
    solve_time: float           # wall-clock seconds of the device loop
    primal: Primal              # final primal (stacked arrays)
    dual: Dual                  # final dual

    @property
    def converged(self) -> bool:
        return self.status == 0

    @property
    def objective(self) -> float:
        """The optimal cost: the root epigraph variable s_0 of the nested
        risk recursion (the CP objective is min <e_{s_0}, z>; reference
        ``cache.py:253-257`` takes the same gradient step on s_0 but never
        surfaces the value). At convergence this equals the risk-recursive
        evaluation of the returned trajectory (tested against an
        independent host-side recursion in tests/test_solver.py)."""
        return float(np.asarray(self.primal.s)[0])

    @property
    def iters_per_second(self) -> float:
        return self.num_iters / self.solve_time if self.solve_time else 0.0

    def save_checkpoint(self, path: str) -> None:
        """Persist (z, eta, k) so a later solve can warm-start
        (:meth:`Solver.solve` ``warm_start=``). The reference keeps the full
        per-iteration history in memory but never resumes from it
        (cache.py:186-196); this is the cheap durable equivalent. One
        writer (:func:`_write_iterate_npz`) serves both this and the
        fault checkpoints of chunked solves, so every checkpoint parses
        with :meth:`load_checkpoint`."""
        _write_iterate_npz(self.primal, self.dual, self.num_iters, path)

    @staticmethod
    def load_checkpoint(path: str):
        """Return (primal, dual, num_iters) from :meth:`save_checkpoint`."""
        data = np.load(path)
        primal = Primal(**{k: data[f"primal_{k}"] for k in Primal._fields})
        dual = Dual(**{k: data[f"dual_{k}"] for k in Dual._fields})
        return primal, dual, int(data["num_iters"])


# Unless a precision is set, a float32 matrix product on the GPU may run in
# TF32, which keeps about three decimal digits: too few for CP residuals to
# reach the reference's 1e-3 tolerance, and too few for the Riccati tables.
# Every solver program is therefore traced under full-float32 matmuls.
# Override (e.g. "tensorfloat32" for throughput experiments at loose
# tolerances) via RAOCP_TPU_MATMUL_PRECISION (read per call, so setting it
# after import takes effect).


def _with_matmul_precision(fn):
    @wraps(fn)
    def wrapper(*args, **kwargs):
        prec = os.environ.get("RAOCP_TPU_MATMUL_PRECISION", "float32")
        with jax.default_matmul_precision(prec):
            return fn(*args, **kwargs)
    return wrapper


def _normalise(z, norm):
    return jax.tree_util.tree_map(lambda v: v / norm, z)


def _sp_primal_dot(sp: StackedProblem, a, b):
    """<a, b> over primal pytrees, correct under the subtree partition.

    Under parallel.subtree the spine rows [0, stage_start[frontier]) of
    every node-space leaf are REPLICATED on all devices (and every primal
    leaf — x/tau/s on the all-node space, u/y on the nonleaf space — has
    its spine in exactly those leading rows), so the global inner product
    is psum(local dot with spine rows downweighted by 1/num_devices).
    Plain tree_dot outside a subtree partition."""
    if sp.spmd_axis is None:
        return tree_dot(a, b)
    spine = sp.stage_start[sp.frontier]
    scale = 1.0 - 1.0 / sp.spmd_ndev

    def wdot(x, y):
        return jnp.vdot(x, y) - scale * jnp.vdot(x[:spine], y[:spine])

    parts = jax.tree_util.tree_map(wdot, a, b)
    local = jnp.sum(jnp.stack(jax.tree_util.tree_leaves(parts)))
    return jax.lax.psum(local, sp.spmd_axis)


@partial(jax.jit, static_argnames=("max_iters",))
@_with_matmul_precision
def _power_iteration(sp: StackedProblem, max_iters: int = 10000,
                     rel_tol: float = 1e-12):
    """lambda_max(L'L) by on-device power iteration on the primal space."""
    key = jax.random.PRNGKey(0)
    template = sp.zero_primal()
    leaves, treedef = jax.tree_util.tree_flatten(template)
    keys = jax.random.split(key, len(leaves))
    # under the subtree partition every device draws the same randoms for
    # its local shapes (same key, same shapes), so the replicated spine
    # rows start consistent across devices
    z0 = jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, l.shape, l.dtype)
                  for k, l in zip(keys, leaves)])
    z0 = _normalise(z0, jnp.sqrt(_sp_primal_dot(sp, z0, z0)))

    def body(carry):
        z, lam_prev, _, k = carry
        w = ell_t(sp, ell(sp, z))
        lam = _sp_primal_dot(sp, z, w)       # Rayleigh quotient (z normalised)
        z_next = _normalise(w, jnp.sqrt(_sp_primal_dot(sp, w, w)))
        return z_next, lam, lam_prev, k + 1

    def cond(carry):
        _, lam, lam_prev, k = carry
        not_conv = jnp.abs(lam - lam_prev) > rel_tol * jnp.abs(lam)
        return jnp.logical_and(jnp.logical_or(k < 2, not_conv), k < max_iters)

    _, lam, _, iters = jax.lax.while_loop(
        cond, body, (z0, jnp.asarray(0.0, sp.dtype),
                     jnp.asarray(-1.0, sp.dtype), 0))
    return lam, iters


def _cp_step(sp: StackedProblem, z, eta, Lz, Lt, alpha1, alpha2, x0):
    """One Chambolle-Pock step on primal/dual PYTREES (no residuals).

    Linear combinations and Moreau arithmetic run per leaf (tree_map) and
    XLA fuses them into the structured maps that consume them, so the
    iterates are never packed into (or unpacked from) one flat vector.

    Carries L z and L'eta so one step costs TWO operator applies (the
    reference uses five, solver.py:27-95; the third apply here is only
    needed for the xi_0 residual — see :func:`_cp_residuals`).
    """
    tmap = jax.tree_util.tree_map
    # primal: z+ = prox_f(z - a1 L'eta)
    z_new = prox_f(sp, tmap(lambda zi, ti: zi - alpha1 * ti, z, Lt),
                   alpha1, x0)
    Lzn = ell(sp, z_new)
    # dual: eta+ = prox_g*(eta + a2 L(2 z+ - z)) via Moreau; the half-shift
    # constant is zero on 7 of 11 leaves (XLA folds those adds away)
    shift = half_shift_dual(sp)
    mod = Dual(*tmap(
        lambda e, lzn, lz, s: (e + alpha2 * (2.0 * lzn - lz)) / alpha2 + s,
        eta, Lzn, Lz, shift))
    proj = g_conj_projections(sp, mod)
    eta_new = Dual(*tmap(lambda m, p: alpha2 * (m - p), mod, proj))
    Ltn = ell_t(sp, eta_new)
    return z_new, eta_new, Lzn, Ltn


def _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, alpha1, alpha2):
    """The xi_0/1/2 and delta_0/1/2 max-norms of one step (reference
    solver.py:63-95). Costs ONE extra operator apply (L' of xi_2).
    Leaf-wise max-abs then max-of-scalars equals the packed inf-norm
    exactly."""
    tmap = jax.tree_util.tree_map
    xi1 = tmap(lambda a, b, c, d: (a - b) / alpha1 - (c - d),
               z, zn, Lt, Ltn)
    xi2 = Dual(*tmap(lambda a, b, c, d: (a - b) / alpha2 + (c - d),
                     eta, en, Lzn, Lz))
    xi0 = tree_add(xi1, ell_t(sp, xi2))
    d1 = tree_sub(zn, z)
    d2 = tree_sub(en, eta)
    d0 = tmap(lambda a, b, c: a - (b - c), d1, Ltn, Lt)
    err = jnp.stack([tree_inf_norm(xi0), tree_inf_norm(xi1),
                     tree_inf_norm(xi2)])
    derr = jnp.stack([tree_inf_norm(d0), tree_inf_norm(d1),
                      tree_inf_norm(d2)])
    if sp.spmd_axis is not None:
        # subtree partition: local max-norms -> global (spine rows are
        # replicated and ghost rows zero, so a plain pmax is exact); ONE
        # fused all-reduce for all six norms, not two
        both = jax.lax.pmax(jnp.concatenate([err, derr]), sp.spmd_axis)
        err, derr = both[:3], both[3:]
    return err, derr


@_with_matmul_precision
def cp_iteration(sp: StackedProblem, z, eta, Lz, LtEta, alpha1, alpha2, x0):
    """One full Chambolle-Pock step + residuals on primal/dual pytrees
    (three operator applies total). Returns (z+, eta+, L z+, L'eta+, err,
    derr) where err/derr are the [xi_0, xi_1, xi_2] /
    [delta_0, delta_1, delta_2] max-norms."""
    zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, LtEta, alpha1, alpha2, x0)
    err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, LtEta, Ltn,
                              alpha1, alpha2)
    return zn, en, Lzn, Ltn, err, derr


def _chunked_loop(run_chunk, z0, eta0, tol, max_iters,
                  checkpoint_on_fault, write_checkpoint):
    """Drive a CP loop in device-bounded chunks with elastic recovery.

    ``run_chunk(z, eta, iters_done) -> (z, eta, it, err, hist)`` executes
    ONE device dispatch of a bounded iteration count (the chunk budget is
    baked into the closure; ``iters_done`` offsets in-loop logging so
    printed iteration indices are global, and iterates stay device-
    resident between chunks). Each completed chunk's iterate is
    snapshotted to HOST memory; a device fault (``JaxRuntimeError``)
    mid-chunk triggers ONE retry from the last snapshot, with a warning
    that names the error — a transient fault costs one repeated chunk of
    identical math. If the retry also fails and ``checkpoint_on_fault``
    is set, ``write_checkpoint(z_np, eta_np, iters, path)`` persists the
    last good iterate before re-raising. Shared by the single-device and
    subtree-partition solve paths (the reference has no failure handling
    of any kind, SURVEY §5)."""
    tmap_np = partial(jax.tree_util.tree_map, np.asarray)
    zc, ec = z0, eta0
    iters = 0
    hists = []
    # host snapshot of the last GOOD iterate: device arrays do not
    # survive a device fault, so recovery resumes from here
    snap = (tmap_np(z0), tmap_np(eta0), 0)
    retried = False
    while True:
        try:
            z, eta, it, err, hist = run_chunk(zc, ec, iters)
            it = int(it)          # forces chunk completion
            hist_np = np.asarray(hist[:it])
        except jax.errors.JaxRuntimeError as e:
            if not retried:
                # redo this one chunk from the last good host snapshot —
                # identical math (the failed chunk's history was never
                # appended, so hists already matches the snapshot). Never
                # silently: the fault may be out-of-memory, not transient.
                warnings.warn(
                    f"device fault in a solve chunk after iteration "
                    f"{snap[2]}; retrying the chunk once: "
                    f"{type(e).__name__}: {e}", RuntimeWarning,
                    stacklevel=3)
                retried = True
                zc, ec, iters = snap
                continue
            if checkpoint_on_fault is not None:
                zs, es, ks = snap
                write_checkpoint(zs, es, ks, checkpoint_on_fault)
                raise RuntimeError(
                    f"device fault persisted after retry; last good "
                    f"iterate (iteration {ks}) saved to "
                    f"{checkpoint_on_fault} — resume via "
                    "solve(warm_start=SolverResult."
                    "load_checkpoint(path)[:2])") from e
            raise
        retried = False
        iters += it
        hists.append(hist_np)
        snap = (tmap_np(z), tmap_np(eta), iters)
        if (float(np.asarray(err).max()) <= tol
                or iters >= max_iters or it == 0):
            break
        zc, ec = z, eta          # device-resident warm start
    hist = np.concatenate(hists) if hists else np.zeros((0, 6))
    return z, eta, iters, err, hist


def _write_iterate_npz(z_np, eta_np, num_iters, path):
    """Persist (z, eta, k) in the SolverResult.save_checkpoint format."""
    primal = {f"primal_{k}": np.asarray(v) for k, v
              in Primal(*z_np)._asdict().items()}
    dual = {f"dual_{k}": np.asarray(v) for k, v
            in Dual(*eta_np)._asdict().items()}
    np.savez(path, num_iters=num_iters, **primal, **dual)


# 'auto' over-relaxation: rho = 1.8 cuts the iteration count by about 40%
# on the BASELINE configs (an iteration-count property, independent of the
# device), and Condat's convergence guarantee covers any rho in (0, 2)
# under the same step rule, so long-solve paths (MPC) default to it. Plain
# solve() keeps relax=1.0 so the DEFAULT solver is iteration-for-iteration
# identical to the reference (the 937-parity invariant).
_AUTO_RELAX = 1.8


def _resolve_relax(relax) -> float:
    if isinstance(relax, str):
        if relax != "auto":
            raise ValueError(f"unknown relax '{relax}' (float or 'auto')")
        return _AUTO_RELAX
    return float(relax)


def _log_residuals(k, err):
    print(f"[raocp_tpu] iter {int(k):>7d}  "
          f"xi_0={float(err[0]):.3e} xi_1={float(err[1]):.3e} "
          f"xi_2={float(err[2]):.3e}")


@partial(jax.jit, static_argnames=("max_iters", "log_every", "check_every",
                                   "unroll", "adaptive", "relax"))
@_with_matmul_precision
def _run_cp(sp: StackedProblem, z0, eta0, x0, alpha1, alpha2, tol,
            max_iters: int, log_every=None, check_every: int = 1,
            unroll: int = 1, adaptive: bool = False, relax: float = 1.0,
            k0=0):
    """The full CP loop. Returns (z, eta, iters, final_errors, histories).

    ``check_every=k`` evaluates the xi residuals (and the stopping test)
    only every k-th iteration: between checks an iteration costs two
    operator applies instead of three. ``1`` (default) reproduces the
    reference's per-iteration stopping exactly (solver.py:124-161); larger
    strides are the production mode (SCS-style periodic checks) — the loop
    may then overshoot the first converged iterate by up to k-1 steps.

    ``unroll=u`` runs u CP steps per ``while_loop`` trip, amortising the
    loop-carry copies and stopping test over u iterations (u must divide
    check_every, or be 1).

    ``adaptive`` enables residual balancing in the style of Goldstein et
    al.'s adaptive PDHG: at every residual check, if the primal residual
    xi_1 dominates the dual residual xi_2 by more than _ADAPT_DELTA the
    primal step grows by 1/(1 - phi) and the dual step shrinks by
    (1 - phi) (and symmetrically), keeping the convergence-critical
    product alpha1*alpha2 exactly constant; the adaptivity level phi
    decays geometrically on every rebalance, so the steps settle and the
    scheme inherits the fixed-step convergence guarantee.

    ``relax=rho`` (static, default 1.0 = plain CP) over-relaxes each step:
    (z, eta) <- (1 - rho) (z, eta) + rho (z~, eta~) where (z~, eta~) is the
    proximal step — Condat's relaxed primal-dual algorithm, convergent for
    rho in (0, 2) under the same alpha1 alpha2 ||L||^2 < 1 rule. The
    residuals are evaluated at the UNRELAXED proximal pair (the CP
    fixed-point residual at the current iterate, same formulas as the
    reference), and the carried L z / L'eta update linearly, so relaxation
    costs four axpys per step and no operator applies.
    """
    if unroll > 1 and check_every % unroll != 0:
        raise ValueError("unroll must divide check_every")

    # residual-balancing constants (Goldstein et al. 2013 defaults)
    _ADAPT_DELTA = 1.5    # imbalance ratio that triggers a rebalance
    _ADAPT_PHI = 0.5      # initial step-change intensity
    _ADAPT_DECAY = 0.95   # phi decay per rebalance

    z = Primal(*z0)
    eta = Dual(*eta0)
    Lz = ell(sp, z)
    Lt = ell_t(sp, eta)
    # + unroll slack rows: k advances in steps of unroll and may overshoot.
    # With strided checks the unchecked rows are never written — NaN-init
    # renders them as gaps (instead of stale stair-steps) in the plots.
    hist = (jnp.zeros((max_iters + unroll, 6), sp.dtype) if check_every == 1
            else jnp.full((max_iters + unroll, 6), jnp.nan, sp.dtype))
    err = jnp.full((3,), jnp.inf, sp.dtype)
    derr = jnp.full((3,), jnp.inf, sp.dtype)
    phi = jnp.asarray(_ADAPT_PHI, sp.dtype)

    def rebalance(a1, a2, phi, err):
        """One residual-balancing update of (alpha1, alpha2, phi)."""
        grow = err[1] > _ADAPT_DELTA * err[2]     # primal residual dominates
        shrink = err[2] > _ADAPT_DELTA * err[1]   # dual residual dominates
        fac = jnp.where(grow, 1.0 / (1.0 - phi),
                        jnp.where(shrink, 1.0 - phi, 1.0))
        phi_new = jnp.where(jnp.logical_or(grow, shrink),
                            phi * _ADAPT_DECAY, phi)
        return a1 * fac, a2 / fac, phi_new

    def body(carry):
        z, eta, Lz, Lt, k, err, derr, hist, a1, a2, phi = carry
        for i in range(unroll):
            zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, a1, a2, x0)

            def fresh(z=z, zn=zn, eta=eta, en=en, Lz=Lz, Lzn=Lzn, Lt=Lt,
                      Ltn=Ltn, a1=a1, a2=a2):
                return _cp_residuals(
                    sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, a1, a2)

            if check_every == 1 or (unroll == check_every
                                    and i == unroll - 1):
                # per-iteration checks, or the statically known check slot
                # of a whole check period per loop trip (unroll ==
                # check_every): no lax.cond, no history write on the other
                # unroll-1 steps — the production configuration
                err, derr = fresh()
                row = jnp.concatenate([err, derr])
                if adaptive:
                    a1, a2, phi = rebalance(a1, a2, phi, err)
                hist = hist.at[k + i].set(row)
            elif i == unroll - 1:
                # unroll divides check_every and k advances by unroll, so
                # only a trip's LAST step can land on a check boundary —
                # the other unroll-1 steps carry no cond and no history
                # write (their rows keep the NaN init: strided histories
                # plot as gaps instead of stale stair-steps)
                checked = (k + i + 1) % check_every == 0
                err, derr = jax.lax.cond(checked, fresh,
                                         lambda: (err, derr))
                if adaptive:
                    a1, a2, phi = jax.tree_util.tree_map(
                        lambda new, old: jnp.where(checked, new, old),
                        rebalance(a1, a2, phi, err), (a1, a2, phi))
                row = jnp.where(checked, jnp.concatenate([err, derr]),
                                jnp.nan)
                hist = hist.at[k + i].set(row)
            if log_every is not None:
                # k0: iterations completed by earlier chunks of a chunked
                # solve — logged indices are GLOBAL (the stride stays
                # chunk-local, matching the restart of the loop counter)
                do_log = (k + i) % log_every == 0
                if sp.spmd_axis is not None:
                    # under shard_map every device runs the callback; err
                    # is the post-pmax global norm (identical everywhere),
                    # so print from device 0 only
                    do_log = jnp.logical_and(
                        do_log, jax.lax.axis_index(sp.spmd_axis) == 0)
                jax.lax.cond(
                    do_log,
                    lambda: jax.debug.callback(_log_residuals,
                                               k0 + k + i, err),
                    lambda: None)
            if relax != 1.0:
                # over-relaxation AFTER the residual evaluation: the
                # residual measures the fixed-point gap at the current
                # iterate; the carried operator images relax linearly
                over = jax.tree_util.tree_map(
                    lambda cur, prox: cur + relax * (prox - cur),
                    (z, eta, Lz, Lt), (zn, en, Lzn, Ltn))
                z, eta, Lz, Lt = over
            else:
                z, eta, Lz, Lt = zn, en, Lzn, Ltn
        return z, eta, Lz, Lt, k + unroll, err, derr, hist, a1, a2, phi

    def cond(carry):
        k, err = carry[4], carry[5]
        # k + unroll <= max_iters + 1: the final trip never pushes the step
        # count past the reference's cap of max_iters + 1 executed steps
        # (reference solver.py:156-159 runs k = 0..max_iters inclusive);
        # with unroll=1 this is exactly the reference stopping rule
        return jnp.logical_or(
            k == 0,
            jnp.logical_and(jnp.max(err) > tol,
                            k + unroll < max_iters + 2))

    out = jax.lax.while_loop(
        cond, body, (z, eta, Lz, Lt, 0, err, derr, hist, alpha1, alpha2,
                     phi))
    z, eta, _, _, iters, err, _, hist = out[:8]
    return z, eta, iters, err, hist[:max_iters + 1]


class Solver:
    """Builds the stacked problem + offline factorisations, then solves.

    :param mesh: optional ``jax.sharding.Mesh`` (1-D, from
        :func:`raocp_tpu.parallel.make_mesh`). When given, the whole CP
        loop runs SPMD over the mesh.
    :param partition: multi-device strategy (needs ``mesh``):

        * ``"subtree"`` — replicated-spine subtree partition
          (:mod:`raocp_tpu.parallel.subtree`): each device owns complete
          subtrees below a frontier stage; ~5 spine-sized collectives per
          iteration. Needs uniform branching below some stage.
        * ``"flat"`` — even GSPMD split of the node axis
          (:mod:`raocp_tpu.parallel.sharding`): works for any tree, but
          shard boundaries cut stage slices, so GSPMD reshards around
          every per-stage op (~140 collectives/iteration).
        * ``"auto"`` (default) — subtree when the tree admits a frontier
          and the mesh has more than one device, flat otherwise.
          ``pad_multiple`` (a flat-layout knob) steers auto to the flat
          path; combining it with the explicit ``partition="subtree"``
          raises.
    """

    def __init__(self, problem_spec: RAOCP, dtype=None,
                 pad_multiple: Optional[int] = None, offline: str = "host",
                 mesh=None, partition: str = "auto"):
        self.__spec = problem_spec
        self.__mesh = mesh
        self.__subtree = None
        if partition not in ("auto", "subtree", "flat"):
            raise ValueError(f"unknown partition '{partition}'")
        if partition == "subtree" and (
                mesh is None or int(mesh.devices.size) < 2):
            raise ValueError(
                "partition='subtree' needs a mesh with more than one "
                "device (raocp_tpu.parallel.make_mesh); otherwise the "
                "solve would silently run the single-device path")
        if partition == "subtree" and pad_multiple is not None \
                and pad_multiple != 1:
            raise ValueError(
                "pad_multiple applies to the flat node layout only; the "
                "subtree partition pads stages to the device count "
                "internally — drop the argument or use partition='flat'")
        # pad_multiple signals flat-layout intent, so partition='auto'
        # honours it by selecting the flat path (raising here would make
        # previously-working auto calls fail only on subtree-eligible tree
        # shapes — behaviour must not depend on the tree's branching)
        if mesh is not None and (
                partition == "subtree"
                or (partition == "auto" and pad_multiple is None)):
            from raocp_tpu.parallel.subtree import (build_subtree_problem,
                                                    choose_frontier)
            # eligibility is a pure function of the tree's stage structure
            # — decide BEFORE paying for a stacked build (the offline
            # factorisations dominate build time at production scale)
            eligible = choose_frontier(problem_spec.tree,
                                       int(mesh.devices.size))
            if partition == "subtree" and eligible is None:
                raise ValueError(
                    "partition='subtree' needs uniform branching below "
                    "some stage; this tree is ragged everywhere — use "
                    "partition='flat'")
            if eligible is not None and int(mesh.devices.size) > 1:
                self.__stacked = build_stacked(
                    problem_spec, dtype=dtype, pad_multiple=1,
                    offline=offline)
                self.__subtree = build_subtree_problem(
                    problem_spec, mesh, dtype=dtype, offline=offline,
                    prebuilt=self.__stacked)
        if self.__subtree is None:
            if pad_multiple is None:
                pad_multiple = mesh.devices.size if mesh is not None else 1
            self.__stacked = build_stacked(problem_spec, dtype=dtype,
                                           pad_multiple=pad_multiple,
                                           offline=offline)
            if mesh is not None:
                from raocp_tpu.parallel.sharding import shard_problem
                self.__stacked = shard_problem(self.__stacked, mesh)
        self.__result: Optional[SolverResult] = None
        self.__lambda_max: Optional[float] = None

    @property
    def subtree(self):
        """The :class:`~raocp_tpu.parallel.subtree.SubtreeProblem` when the
        solver runs the replicated-spine partition, else None."""
        return self.__subtree

    def operator_norm_sq(self) -> float:
        """lambda_max(L'L), memoised per Solver. The stacked problem is
        immutable once built, so ||L|| never changes — warm-started MPC
        loops and repeated :meth:`solve` calls pay the power iteration
        (hundreds of L/L' applies at rel_tol 1e-12) exactly once."""
        if self.__lambda_max is None:
            if self.__subtree is not None:
                lam, _ = self.__subtree.power_iteration()
            else:
                lam, _ = _power_iteration(self.__stacked)
            self.__lambda_max = float(lam)
        return self.__lambda_max

    @property
    def stacked(self) -> StackedProblem:
        return self.__stacked

    @property
    def spec(self) -> RAOCP:
        return self.__spec

    @property
    def result(self) -> Optional[SolverResult]:
        return self.__result

    def solve(self, initial_state, max_iters: int = 10, tol: float = 1e-5,
              alpha: Optional[float] = None, warm_start=None,
              log_every: Optional[int] = None,
              profile_dir: Optional[str] = None,
              accel: Optional[str] = None,
              accel_memory: int = 5,
              check_every: int = 1,
              unroll: int = 1,
              step_ratio: float = 1.0,
              adaptive: bool = False,
              relax: float = 1.0,
              chunk_iters: Optional[int] = None,
              checkpoint_on_fault: Optional[str] = None) -> SolverResult:
        """Run Chambolle-Pock with the given initial state.

        :param alpha: overrides the 0.999/lambda_max(L'L) step rule
        :param warm_start: optional (primal, dual) pytrees (e.g. from
            :meth:`SolverResult.load_checkpoint`) to resume from instead of
            the zero iterate
        :param log_every: if set, print the residuals every k iterations
            from inside the device loop (host callback)
        :param profile_dir: if set, wrap the solve in a ``jax.profiler``
            trace written to this directory
        :param accel: ``None`` (plain CP, iteration-for-iteration identical
            to the reference), ``"anderson"`` (safeguarded Anderson
            acceleration of the fixed point), or ``"supermann"`` /
            ``"broyden"`` (SuperMann-style globalisation with
            limited-memory Broyden quasi-Newton directions; ``"lbfgs"`` is
            accepted as a legacy alias) — see :mod:`raocp_tpu.accel`
        :param accel_memory: Anderson / Broyden history depth
        :param check_every: evaluate the convergence residuals every k-th
            iteration. 1 (default) matches the reference's per-iteration
            stopping test exactly; larger strides (e.g. 25) skip the
            residual-only operator apply between checks — ~1/3 less work
            per iteration, at the price of overshooting convergence by up
            to k-1 iterations. Also honoured by the ``accel`` loops (their
            safeguards run on the free fixed-point residual norm; only
            the xi stopping check is strided).
        :param unroll: CP steps per device-loop trip (must divide
            ``check_every``); amortises loop bookkeeping. Plain CP only.
        :param step_ratio: primal/dual step balancing gamma: runs with
            alpha1 = gamma * alpha, alpha2 = alpha / gamma — the product
            alpha1 * alpha2 (what CP convergence constrains) is unchanged,
            so any gamma > 0 converges, but a well-chosen ratio can cut the
            iteration count substantially on badly scaled problems (the
            reference hardwires gamma = 1, ``solver.py:114-118``). Plain CP
            only (ignored under ``accel``).
        :param adaptive: residual balancing (adaptive PDHG, Goldstein et
            al.): at every residual check, rebalance alpha1/alpha2 toward
            whichever of xi_1/xi_2 dominates, keeping alpha1*alpha2
            constant, with geometrically decaying intensity — an automatic,
            convergent version of hand-tuning ``step_ratio``. The returned
            ``alpha`` is the initial step. Plain CP only (ignored under
            ``accel``).
        :param relax: over-relaxation factor rho in (0, 2) (Condat 2013),
            or ``"auto"`` for the long-solve default (1.8; the MPC path
            defaults to it):
            each iterate is (1 - rho) z + rho z~ where z~ is the proximal
            step. 1.0 (default) is plain CP, iteration-for-iteration
            identical to the reference; rho = 1.8 cuts the iteration count
            ~40% (10,175 -> 6,150 on the 9,841-node/50-state benchmark).
            No additional operator applies — the carried images relax
            linearly — but the four relaxation AXPYS are not free on a
            bandwidth-bound iteration, so whether it wins on time to
            tolerance is a per-device measurement.
            Note rho is a STATIC jit argument (keeps the plain-CP program
            free of the four relaxation axpys): every distinct value
            recompiles the loop, so avoid fine-grained rho sweeps. Plain
            CP only (ignored under ``accel``).
        :param chunk_iters: cap each DEVICE execution at this many
            iterations and resume on the host until convergence or
            ``max_iters`` (iterates stay on device between chunks; the
            histories concatenate, so results are identical up to the
            chunk-boundary residual checks). Chunking bounds what one
            device fault can cost to one chunk of a long solve.
            Plain CP only; with ``adaptive`` the rebalance state restarts
            at each chunk boundary. ELASTIC RECOVERY: each completed
            chunk's iterate is snapshotted to host memory; a device fault
            (``JaxRuntimeError``) mid-chunk triggers ONE retry from the
            last snapshot, with a ``RuntimeWarning`` that names the error
            (a transient fault costs one repeated chunk of identical
            math).
        :param checkpoint_on_fault: with ``chunk_iters``, a path: if the
            retry also fails (backend wedged), the last good iterate and
            iteration count are written there before re-raising — a fresh
            process resumes via ``solve(warm_start=
            SolverResult.load_checkpoint(path)[:2])``. The reference has
            no failure handling of any kind (SURVEY §5).
        """
        sp = self.__stacked
        relax = _resolve_relax(relax)
        x0_np = np.asarray(initial_state, dtype=np.float64).reshape(-1)
        x0 = jnp.asarray(x0_np, dtype=sp.dtype)
        if x0.shape != (sp.n,):
            raise ValueError(f"initial state must have {sp.n} entries")
        if self.__subtree is not None:
            return self._solve_subtree(
                x0_np, max_iters=max_iters, tol=tol, alpha=alpha,
                warm_start=warm_start, log_every=log_every,
                profile_dir=profile_dir, accel=accel,
                check_every=check_every, unroll=unroll,
                step_ratio=step_ratio, adaptive=adaptive, relax=relax,
                chunk_iters=chunk_iters,
                checkpoint_on_fault=checkpoint_on_fault)
        if alpha is None:
            alpha = 0.999 / self.operator_norm_sq()
        if warm_start is None:
            # host-side cold start (no eager device dispatch); the jitted
            # loop transfers the zeros once at call time
            z0 = sp.zero_primal(xp=np)
            # reference cache_initial_state (solver.py:101-102)
            z0.x[0] = x0_np.astype(z0.x.dtype)
            eta0 = sp.zero_dual(xp=np)
        else:
            z0, eta0 = warm_start
            z0 = jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, sp.dtype), Primal(*z0))
            eta0 = jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, sp.dtype), Dual(*eta0))
        if self.__mesh is not None:
            # place the iterates on the mesh explicitly so the loop program
            # starts node-sharded (instead of jit choosing a layout)
            from raocp_tpu.parallel.sharding import shard_variables
            z0 = shard_variables(z0, self.__mesh)
            eta0 = shard_variables(eta0, self.__mesh)
        import contextlib
        profiler_cm = (jax.profiler.trace(profile_dir) if profile_dir
                       else contextlib.nullcontext())
        tic = time.perf_counter()
        if step_ratio <= 0.0:
            raise ValueError(f"step_ratio must be positive, got {step_ratio}")
        if not 0.0 < relax < 2.0:
            raise ValueError(f"relax must lie in (0, 2), got {relax}")
        with profiler_cm:
            if accel is None and chunk_iters is not None:
                a1 = jnp.asarray(alpha * step_ratio, sp.dtype)
                a2 = jnp.asarray(alpha / step_ratio, sp.dtype)
                tolj = jnp.asarray(tol, sp.dtype)

                # constant per-chunk budget: a shrunken final chunk would
                # recompile the loop (max_iters is static), so the
                # max_iters cap rounds up to a chunk multiple instead
                def run_chunk(zc, ec, iters_done):
                    return _run_cp(
                        sp, tuple(zc), tuple(ec), x0, a1, a2, tolj,
                        int(chunk_iters), log_every, check_every,
                        unroll, adaptive, float(relax), k0=iters_done)

                z, eta, iters, err, hist = _chunked_loop(
                    run_chunk, z0, eta0, tol, max_iters,
                    checkpoint_on_fault, _write_iterate_npz)
            elif accel is None:
                z, eta, iters, err, hist = _run_cp(
                    sp, z0, eta0, x0,
                    jnp.asarray(alpha * step_ratio, sp.dtype),
                    jnp.asarray(alpha / step_ratio, sp.dtype),
                    jnp.asarray(tol, sp.dtype),
                    max_iters, log_every, check_every, unroll, adaptive,
                    float(relax))
            elif accel == "anderson":
                from raocp_tpu.accel import run_cp_anderson
                z, eta, iters, _evals, err, hist = run_cp_anderson(
                    sp, z0, eta0, x0, jnp.asarray(alpha, sp.dtype),
                    jnp.asarray(tol, sp.dtype), max_iters,
                    memory=accel_memory, check_every=check_every)
            elif accel in ("supermann", "broyden", "lbfgs"):
                from raocp_tpu.accel import run_cp_supermann
                z, eta, iters, _evals, err, hist = run_cp_supermann(
                    sp, z0, eta0, x0, jnp.asarray(alpha, sp.dtype),
                    jnp.asarray(tol, sp.dtype), max_iters,
                    memory=accel_memory, check_every=check_every)
            else:
                raise ValueError(f"unknown accel '{accel}'")
            jax.block_until_ready(err)
        iters = int(iters)
        err = np.asarray(err)
        toc = time.perf_counter()
        hist = np.asarray(hist[:iters])
        self.__result = SolverResult(
            status=0 if float(err.max()) <= tol else 1,
            num_iters=iters,
            xi=err,
            xi_history=hist[:, :3],
            delta_history=hist[:, 3:],
            alpha=float(alpha),
            solve_time=toc - tic,
            primal=jax.tree_util.tree_map(np.asarray, z),
            dual=jax.tree_util.tree_map(np.asarray, eta),
        )
        return self.__result

    def _solve_subtree(self, x0_np, max_iters, tol, alpha, warm_start,
                       log_every, profile_dir, accel, check_every, unroll,
                       step_ratio, adaptive, relax, chunk_iters=None,
                       checkpoint_on_fault=None) -> SolverResult:
        """Chambolle-Pock under the replicated-spine subtree partition
        (:mod:`raocp_tpu.parallel.subtree`): the production loop runs
        inside one shard_map over the mesh; iterates live in the
        [num_devices * local_rows, ...] block layout and results are
        repacked to the global node layout, so :meth:`validate`, plots,
        checkpoints, and warm starts are layout-agnostic. ``chunk_iters``
        / ``checkpoint_on_fault`` run the same elastic-recovery chunk
        driver as the single-device path; the fault checkpoint is written
        in the GLOBAL node layout, so a fresh process can resume with any
        partition. ``log_every`` prints from inside the shard_mapped loop
        (device 0 only)."""
        stp = self.__subtree
        sp = stp.sp
        if accel is not None:
            raise ValueError(
                "accelerated loops are not supported under the subtree "
                "partition yet; use partition='flat' for accel runs")
        if step_ratio <= 0.0:
            raise ValueError(f"step_ratio must be positive, got {step_ratio}")
        if not 0.0 < relax < 2.0:
            raise ValueError(f"relax must lie in (0, 2), got {relax}")
        if alpha is None:
            alpha = 0.999 / self.operator_norm_sq()
        if warm_start is None:
            z0 = stp.zero_primal_global_layout()
            # the root is local row 0 on EVERY device (replicated spine)
            z0.x[::stp.l_np] = x0_np.astype(z0.x.dtype)
            eta0 = stp.zero_dual_global_layout()
        else:
            zg, eg = warm_start
            z0 = stp.primal_to_local(Primal(*zg))
            eta0 = stp.dual_to_local(Dual(*eg))
        import contextlib
        profiler_cm = (jax.profiler.trace(profile_dir) if profile_dir
                       else contextlib.nullcontext())
        x0 = jnp.asarray(x0_np, sp.dtype)
        a1 = jnp.asarray(alpha * step_ratio, sp.dtype)
        a2 = jnp.asarray(alpha / step_ratio, sp.dtype)
        tolj = jnp.asarray(tol, sp.dtype)
        tic = time.perf_counter()
        with profiler_cm:
            if chunk_iters is not None:
                def run_chunk(zc, ec, iters_done):
                    return stp.run_cp(
                        zc, ec, x0, a1, a2, tolj, int(chunk_iters),
                        check_every=check_every, unroll=unroll,
                        adaptive=adaptive, relax=float(relax),
                        log_every=log_every, k0=iters_done)

                def write_ckpt(z_np, eta_np, k, path):
                    # block layout -> global node layout: the checkpoint
                    # resumes under ANY partition (or none)
                    _write_iterate_npz(
                        stp.primal_to_global(Primal(*z_np)),
                        stp.dual_to_global(Dual(*eta_np)), k, path)

                z, eta, iters, err, hist = _chunked_loop(
                    run_chunk, z0, eta0, tol, max_iters,
                    checkpoint_on_fault, write_ckpt)
            else:
                z, eta, iters, err, hist = stp.run_cp(
                    z0, eta0, x0, a1, a2, tolj,
                    max_iters, check_every=check_every, unroll=unroll,
                    adaptive=adaptive, relax=float(relax),
                    log_every=log_every)
            jax.block_until_ready(err)
        iters = int(iters)
        err = np.asarray(err)
        toc = time.perf_counter()
        hist = np.asarray(hist[:iters])
        self.__result = SolverResult(
            status=0 if float(err.max()) <= tol else 1,
            num_iters=iters,
            xi=err,
            xi_history=hist[:, :3],
            delta_history=hist[:, 3:],
            alpha=float(alpha),
            solve_time=toc - tic,
            primal=stp.primal_to_global(z),
            dual=stp.dual_to_global(eta),
        )
        return self.__result

    def solve_batch(self, initial_states, max_iters: int = 10,
                    tol: float = 1e-5, alpha: Optional[float] = None,
                    check_every: int = 1, unroll: int = 1,
                    step_ratio: float = 1.0, adaptive: bool = False,
                    relax: float = 1.0) -> list:
        """Solve the SAME problem for a BATCH of initial states in one
        device program — ``jax.vmap`` of the whole CP loop over the leading
        batch axis. A capability with no reference counterpart (one
        ``chock`` call per scenario there): the lanes share every kernel
        launch and batch the per-stage matmuls, so B solves can cost far
        less than B sequential calls for small/medium trees.

        Per-element semantics are EXACT: under vmap the ``while_loop``
        freezes converged lanes (carry select), so each element stops at
        its own iteration count — an element with the single-solve's
        initial state reproduces its iteration count exactly and its
        iterates to machine precision (tested: the 937-parity element
        inside a batch). Wall-clock is the max over the batch.

        Accepts the plain-CP options of :meth:`solve` (no ``accel`` /
        ``log_every`` / ``warm_start``). Returns a list of
        :class:`SolverResult`, one per initial state, sharing the batch
        wall-clock time. :attr:`result` is cleared (a later no-arg
        :meth:`validate` / plot call must not silently operate on a stale
        single-solve result) — validate batch elements explicitly via
        ``solver.validate(results[b])``.
        """
        if self.__subtree is not None:
            raise ValueError("solve_batch is not supported under the "
                             "subtree partition; use partition='flat'")
        sp = self.__stacked
        x0s = np.asarray(initial_states, dtype=np.float64)
        if x0s.ndim != 2 or x0s.shape[1] != sp.n:
            raise ValueError(
                f"initial_states must be [batch, {sp.n}], got {x0s.shape}")
        batch = x0s.shape[0]
        relax = _resolve_relax(relax)
        if alpha is None:
            alpha = 0.999 / self.operator_norm_sq()
        if step_ratio <= 0.0:
            raise ValueError(f"step_ratio must be positive, got {step_ratio}")
        if not 0.0 < relax < 2.0:
            raise ValueError(f"relax must lie in (0, 2), got {relax}")
        z0 = sp.zero_primal(xp=np)
        z0s = jax.tree_util.tree_map(
            lambda v: np.broadcast_to(v, (batch,) + v.shape).copy(), z0)
        z0s.x[:, 0, :] = x0s.astype(z0s.x.dtype)
        eta0 = sp.zero_dual(xp=np)
        eta0s = jax.tree_util.tree_map(
            lambda v: np.broadcast_to(v, (batch,) + v.shape).copy(), eta0)
        run = jax.vmap(
            partial(_run_cp, max_iters=max_iters, check_every=check_every,
                    unroll=unroll, adaptive=adaptive, relax=float(relax)),
            in_axes=(None, 0, 0, 0, None, None, None))
        tic = time.perf_counter()
        z, eta, iters, err, hist = run(
            sp, tuple(z0s), tuple(eta0s), jnp.asarray(x0s, sp.dtype),
            jnp.asarray(alpha * step_ratio, sp.dtype),
            jnp.asarray(alpha / step_ratio, sp.dtype),
            jnp.asarray(tol, sp.dtype))
        jax.block_until_ready(err)
        toc = time.perf_counter()
        iters = np.asarray(iters)
        err = np.asarray(err)
        hist = np.asarray(hist)
        z = jax.tree_util.tree_map(np.asarray, Primal(*z))
        eta = jax.tree_util.tree_map(np.asarray, Dual(*eta))
        self.__result = None     # no single "current" result after a batch
        results = []
        for b in range(batch):
            nb = int(iters[b])
            results.append(SolverResult(
                status=0 if float(err[b].max()) <= tol else 1,
                num_iters=nb,
                xi=err[b],
                xi_history=hist[b, :nb, :3],
                delta_history=hist[b, :nb, 3:],
                alpha=float(alpha),
                solve_time=toc - tic,
                primal=jax.tree_util.tree_map(lambda v, b=b: v[b], z),
                dual=jax.tree_util.tree_map(lambda v, b=b: v[b], eta),
            ))
        return results

    def chock(self, initial_state, max_iters: int = 10,
              tol: float = 1e-5) -> int:
        """Reference-parity entry point (``solver.py:97``): returns 0 on
        convergence, 1 otherwise; rich results stay on :attr:`result`."""
        return self.solve(initial_state, max_iters=max_iters, tol=tol).status

    # -- reporting (parity: reference solver.py:173-253) ---------------------

    def print_states(self) -> None:
        print("states =\n")
        for row in self.__result.primal.x:
            print(f"{row.reshape(-1, 1)}\n")

    def print_inputs(self) -> None:
        print("inputs =\n")
        for row in self.__result.primal.u:
            print(f"{row.reshape(-1, 1)}\n")

    def plot_residuals(self, filename: Optional[str] = None, show: bool = True):
        from raocp_tpu.utils.plots import plot_residuals
        return plot_residuals(self.__result, filename=filename, show=show)

    def plot_solution(self, filename: Optional[str] = None, show: bool = True):
        from raocp_tpu.utils.plots import plot_solution
        return plot_solution(self.__spec.tree, self.__result,
                             filename=filename, show=show)

    def save_residuals_tex(self, filename: str) -> None:
        """pgfplots export of the residual curves (reference writes
        '4-3-residuals.tex', ``solver.py:199``)."""
        from raocp_tpu.utils.plots import save_residuals_tex
        save_residuals_tex(self.__result, filename)

    def save_solution_tex(self, filename: str) -> None:
        """pgfplots export of the trajectory fans (reference writes
        'python-solution.tex', ``solver.py:253``)."""
        from raocp_tpu.utils.plots import save_solution_tex
        save_solution_tex(self.__spec.tree, self.__result, filename)

    def validate(self, result: Optional[SolverResult] = None) -> dict:
        """Host-side sanity check of a solution — the debug-mode analogue of
        the reference's runtime kernel-projection self-check
        (``cache.py:311-312``), run once after the solve instead of every
        iteration. Returns max-norm violations of:

        * ``dynamics``: x_j - (A_j x_i + B_j u_i) over non-root nodes
        * ``kernel``: the risk-recursion kernel constraint M_i [y; tau; s]
        * ``constraints``: distance of [x; u] / x to each node's constraint
          set (0 when feasible)
        """
        res = result if result is not None else self.__result
        if res is None:
            raise RuntimeError("no solve result to validate")
        sp = self.__stacked
        spec = self.__spec
        tree = spec.tree
        x = np.asarray(res.primal.x)
        u = np.asarray(res.primal.u)
        y = np.asarray(res.primal.y)
        tau = np.asarray(res.primal.tau)
        s = np.asarray(res.primal.s)
        NL, N = sp.num_nonleaf, sp.num_nodes

        # Everything below is batched numpy — an earlier per-node Python
        # loop version took minutes at 1e5 nodes (it was invoked after
        # every bench solve), this takes milliseconds at 1e5 x 100 states.
        # The O(num_nodes) Python setup (mode interning, per-node risk
        # grouping) is cached per Solver — the spec is immutable once the
        # problem is built, so repeated validation (e.g. per MPC step at
        # 1e5 nodes) pays it once.
        plan = self._validate_plan()
        modes_a, modes_b, w_idx = plan["dynamics"]
        anc = tree.ancestors
        dyn = 0.0
        for w in range(1, modes_a.shape[0]):
            nodes = np.nonzero(w_idx == w)[0]
            nodes = nodes[nodes >= 1]
            if nodes.size == 0:
                continue
            par = anc[nodes]
            pred = x[par] @ modes_a[w].T + u[par] @ modes_b[w].T
            dyn = max(dyn, float(np.abs(x[nodes] - pred).max()))

        # kernel: group nonleaf nodes by distinct (E, F, child count) and
        # evaluate ||M [y; tau_ch; s_ch]||_inf as one batched matmul each
        ker = 0.0
        ch_idx = tree.children_padded
        for E, F, c, nodes in plan["kernel_groups"]:
            nodes = np.asarray(nodes)
            eye, zc = np.eye(c), np.zeros((F.shape[1], c))
            M = np.vstack((np.hstack((E.T, -eye, -eye)),
                           np.hstack((F.T, zc, zc))))
            ch = ch_idx[nodes, :c]
            V = np.concatenate(
                [y[nodes, :E.shape[0]], tau[ch], s[ch]], axis=1)
            if V.size:
                ker = max(ker, float(np.abs(V @ M.T).max()))

        # constraints: evaluated from the stacked tables (same semantics as
        # the per-node Constraint.violation oracles — Rectangle/Polyhedral
        # row residuals; Ball max-norm distance to the Euclidean projection)
        def table_violation(v, G, lo, hi, active, ball_c, ball_r):
            act = active > 0.0
            if not act.any():
                return 0.0
            img = v if G is None else v @ G.T
            rect = np.maximum(np.maximum(lo - img, img - hi), 0.0)
            rect = np.where(np.isfinite(rect), rect, 0.0).max(axis=1)
            diff = v - ball_c
            dist = np.linalg.norm(diff, axis=1)
            with np.errstate(divide="ignore", invalid="ignore"):
                factor = np.where(
                    dist > ball_r, 1.0 - ball_r / np.maximum(dist, 1e-300),
                    0.0)
            ball = factor * np.abs(diff).max(axis=1)
            return float(np.maximum(rect, ball)[act].max())

        xu = np.concatenate([x[:NL], u[:NL]], axis=1)
        con = table_violation(
            xu, None if sp.nl_G is None else np.asarray(sp.nl_G),
            np.asarray(sp.nl_lo[:NL]), np.asarray(sp.nl_hi[:NL]),
            np.asarray(sp.nl_active[:NL]), np.asarray(sp.nl_ball_c[:NL]),
            np.asarray(sp.nl_ball_r[:NL]))
        LF = N - NL
        con = max(con, table_violation(
            x[NL:N], None if sp.l_G is None else np.asarray(sp.l_G),
            np.asarray(sp.l_lo[:LF]), np.asarray(sp.l_hi[:LF]),
            np.asarray(sp.l_active[:LF]), np.asarray(sp.l_ball_c[:LF]),
            np.asarray(sp.l_ball_r[:LF])))

        # spot-check a deterministic node sample against the SPEC's
        # per-node Constraint.violation oracles — independent of the
        # stacked tables, so a bug in build_stacked's constraint-table
        # construction is caught here instead of the tables verifying
        # themselves (ADVICE r4)
        for i in plan["nl_sample"]:
            c = spec.nonleaf_constraint_at_node(int(i))
            if c.is_active:
                con = max(con, float(c.violation(xu[i])))
        for i in plan["lf_sample"]:
            c = spec.leaf_constraint_at_node(int(NL + i))
            if c.is_active:
                con = max(con, float(c.violation(x[NL + i])))

        return {"dynamics": dyn, "kernel": ker, "constraints": con}

    def _validate_plan(self) -> dict:
        """Cached O(num_nodes) host setup for :meth:`validate`: dynamics
        mode interning, per-risk kernel grouping, and the constraint
        spot-check node samples. The spec is immutable after construction,
        so this runs once per Solver."""
        if getattr(self, "_Solver__validate_plan", None) is not None:
            return self.__validate_plan
        sp = self.__stacked
        spec = self.__spec
        tree = spec.tree
        NL, N = sp.num_nonleaf, sp.num_nodes
        from raocp_tpu.core.stacked import _dedup_dynamics
        groups: dict = {}
        for i in range(NL):
            risk = spec.risk_at_node(i)
            E, F = risk.matrix_e, risk.matrix_f
            c = int(tree.child_count[i])
            key = (E.shape, E.tobytes(), F.shape, F.tobytes(), c)
            groups.setdefault(key, (E, F, c, []))[3].append(i)
        # <= 64 evenly spaced nodes per class: enough to catch a
        # systematically wrong table at O(1) oracle cost
        nl_sample = np.unique(np.linspace(0, NL - 1, min(NL, 64),
                                          dtype=np.int64)) if NL else []
        lf = N - NL
        lf_sample = np.unique(np.linspace(0, lf - 1, min(lf, 64),
                                          dtype=np.int64)) if lf else []
        self.__validate_plan = {
            "dynamics": _dedup_dynamics(spec, sp.n, sp.m),
            "kernel_groups": list(groups.values()),
            "nl_sample": nl_sample,
            "lf_sample": lf_sample,
        }
        return self.__validate_plan
