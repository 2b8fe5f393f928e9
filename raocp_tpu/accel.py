"""Accelerated fixed-point iterations for the Chambolle-Pock map.

The CP iteration is a (quasi-)nonexpansive fixed-point map T on the joint
primal-dual vector w = (z, eta). This module provides two on-device
accelerators of that fixed point, both globalised so they inherit the
convergence of plain CP:

* :func:`run_cp_anderson` — safeguarded Anderson acceleration (type II)
* :func:`run_cp_supermann` — SuperMann-style globalisation with
  limited-memory Broyden quasi-Newton directions on the residual map

Anderson acceleration works as follows:

  r_k = T(w_k) - w_k
  gamma* = argmin || r_k - dR gamma ||_2      (small regularised LS)
  w_cand = w_k + r_k - (dW + dR) gamma*
  accept w_cand iff its fixed-point residual contracts vs the best seen
  (||r_cand|| <= theta * ||r_safe||), else fall back to the plain step
  w_{k+1} = T(w_k) — which guarantees the safeguarded iteration inherits
  the convergence of plain CP.

Layout: everything is carried as PYTREES, as in the plain loop — an
earlier design flat-packed (z, eta) with ``ravel_pytree`` before every
T-map call, which copies the whole iterate each evaluation. Two structural
consequences:

* **Extended vectors.** Every point is carried as W = (z, eta, Lz, L'eta).
  Because L and L' are linear, the image components of ANY affine
  combination of consistent extended vectors are themselves consistent
  images — so Anderson mixing, Broyden directions, line-search candidates
  and fallbacks all produce points whose operator images come for free,
  and one T evaluation costs exactly the plain step's TWO operator applies
  (the flat design paid five: fresh L z, L'eta, plus the step's three).
* **Circular histories.** The difference histories are pytrees with a
  leading ``[memory]`` axis written at slot ``k % memory`` (inner products
  and the Anderson normal equations are order-independent; so is the
  limited-memory Broyden SUM form below). A ``jnp.roll`` push would
  rewrite the entire O(memory x dim) buffer every iteration — at 1e5
  nodes that is hundreds of MB of pure relayout traffic per step.

Everything (histories, the m x m normal equations, the candidate and
safeguard evaluations) stays on device inside one ``lax.while_loop``.
``check_every=k`` evaluates the xi stopping residuals (one extra operator
apply) only every k-th accepted iteration — the safeguards themselves run
on the fixed-point residual norm, which is free — matching the plain
loop's production stride semantics.

The reference repo only sketches this direction (playground/l-bfgs.py is a
standalone L-BFGS scratchpad; BASELINE.json lists "SuperMann/L-BFGS
accelerated iterations" as the target feature) — there is no accelerated
solver in the reference library itself.
"""

from functools import partial, reduce

import jax
import jax.numpy as jnp

from raocp_tpu.core.stacked import StackedProblem
from raocp_tpu.ops.operator import ell, ell_t
from raocp_tpu.core.variables import Dual, Primal, tree_dot
from raocp_tpu.solver import _cp_residuals, _cp_step, \
    _with_matmul_precision as _precision

__all__ = ["run_cp_anderson", "run_cp_supermann"]


# -- extended-vector + pytree-history primitives -----------------------------

def _t_ext(sp, W, alpha, x0):
    """One CP step on an extended point W = (z, eta, Lz, L'eta): returns
    T(W) extended. Two operator applies (ell of z+, ell_t of eta+) — the
    images of the INPUT ride in the carry."""
    z, eta, Lz, Lt = W
    return _cp_step(sp, z, eta, Lz, Lt, alpha, alpha, x0)


def _true(W):
    """The (z, eta) components — the actual joint vector the fixed-point
    theory lives on; norms/inner products ignore the carried images."""
    return (W[0], W[1])


def _norm(W_true):
    return jnp.sqrt(tree_dot(W_true, W_true))


_tmap = jax.tree_util.tree_map


def _add(a, b):
    return _tmap(jnp.add, a, b)


def _sub(a, b):
    return _tmap(jnp.subtract, a, b)


def _sum_leaves(tree):
    return reduce(jnp.add, jax.tree_util.tree_leaves(tree))


def _h_zeros(template, memory):
    """History buffer: the template pytree with a leading [memory] axis."""
    return _tmap(lambda l: jnp.zeros((memory,) + l.shape, l.dtype), template)


def _h_set(hist, slot, row):
    """Write one history row at (dynamic) circular slot."""
    return _tmap(lambda h, r: h.at[slot].set(r), hist, row)


def _h_dot(hist_true, vec_true):
    """[memory] vector of <row_m, v> inner products (true components)."""
    return _sum_leaves(_tmap(
        lambda h, v: jnp.einsum("m...,...->m", h, v), hist_true, vec_true))


def _h_gram(hist_true):
    """[memory, memory] Gram matrix of the history rows (true components)."""
    return _sum_leaves(_tmap(
        lambda h: jnp.einsum("m...,n...->mn", h, h), hist_true))


def _h_combo(hist, gamma):
    """sum_m gamma[m] * row_m as a row-shaped pytree (extended: the combo
    runs over images too, keeping the result a consistent extended point).
    Invalid rows are excluded by zeroing their gamma entries — masking in
    the [memory] space instead of touching the O(memory x dim) buffers."""
    return _tmap(lambda h: jnp.einsum("m...,m->...", h, gamma), hist)


def _residual_row(sp, W, T, alpha):
    """The xi/delta stopping residuals of the step W -> T(W) (reference
    solver.py:63-95 formulas; one extra operator apply for L' of xi_2)."""
    z, eta, Lz, Lt = W
    zn, en, Lzn, Ltn = T
    return _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, alpha, alpha)


@partial(jax.jit, static_argnames=("max_iters", "memory", "check_every"))
@_precision
def run_cp_anderson(sp: StackedProblem, z0, eta0, x0, alpha, tol,
                    max_iters: int, memory: int = 5, theta: float = 1.0,
                    reg: float = 1e-10, check_every: int = 1):
    """Safeguarded Anderson-accelerated CP. Returns
    (z, eta, iters, t_evals, err, hist) with hist rows
    [xi_0, xi_1, xi_2, delta_0, delta_1, delta_2] (NaN between strided
    checks).

    ``theta`` is the safeguard: accept the Anderson candidate iff its
    fixed-point residual satisfies ||r_cand|| <= theta * ||r||. The CP map
    is (quasi-)NONEXPANSIVE, contracting ~1e-4 per step near convergence,
    so demanding strict contraction rejects nearly every candidate — the
    old default 0.9 measured 2.0 T-evals/iteration (every candidate
    rejected and re-evaluated) and only a 13% iteration cut on the
    9,841-node benchmark. theta = 1.0 (accept when not worse) measured
    1.04 evals/iteration and a 40% cut (10,175 -> 6,150 iterations)
    while the monotone-residual safeguard still
    rules out divergence.
    """
    dt = sp.dtype
    z0, eta0 = Primal(*z0), Dual(*eta0)
    W0 = (z0, eta0, ell(sp, z0), ell_t(sp, eta0))
    T0 = _t_ext(sp, W0, alpha, x0)
    R0 = _sub(T0, W0)                      # r = T(w) - w, extended
    err0, derr0 = _residual_row(sp, W0, T0, alpha)

    dW = _h_zeros(W0, memory)
    dR = _h_zeros(W0, memory)
    G0 = jnp.zeros((memory, memory), dt)
    hist = (jnp.zeros((max_iters + 1, 6), dt) if check_every == 1
            else jnp.full((max_iters + 1, 6), jnp.nan, dt))

    # carry: W, R, err/derr (xi at last check), histories, the Gram matrix
    # G = dR dR' (maintained INCREMENTALLY: a push touches one row+column
    # via a single [memory x dim] pass instead of re-reading the whole
    # history for the full Gram each iteration — at 1e4 nodes the O(m^2 d)
    # recompute was the dominant accel cost), counters
    #   k: accepted iterations; evals: T evaluations; pushes: rows written
    state = (W0, R0, err0, derr0, dW, dR, G0, jnp.asarray(0, jnp.int32),
             jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32), hist)

    def cond(state):
        err, k = state[2], state[7]
        return jnp.logical_or(k == 0,
                              jnp.logical_and(jnp.max(err) > tol,
                                              k < max_iters + 1))

    def body(state):
        W, R, err, derr, dW, dR, G, k, evals, pushes, hist = state
        valid = (jnp.arange(memory) < pushes).astype(dt)

        # Anderson candidate from the valid history rows; the normal
        # equations and masking live entirely in the [memory] space
        Gm = G * (valid[:, None] * valid[None, :]) \
            + reg * jnp.eye(memory, dtype=dt)
        b = _h_dot(_true(dR), _true(R)) * valid
        gamma = jnp.linalg.solve(Gm, b) * valid
        W_cand = _sub(_add(W, R), _add(_h_combo(dW, gamma),
                                       _h_combo(dR, gamma)))

        T_cand = _t_ext(sp, W_cand, alpha, x0)
        R_cand = _sub(T_cand, W_cand)
        accept = jnp.logical_and(
            pushes > 0, _norm(_true(R_cand)) <= theta * _norm(_true(R)))

        def accepted(_):
            return W_cand, R_cand, evals + 1

        def fallback(_):
            # plain CP step w+ = T(w) = w + r (extended, already
            # evaluated); one more T eval refreshes the residual there
            W_plain = _add(W, R)
            T_plain = _t_ext(sp, W_plain, alpha, x0)
            return W_plain, _sub(T_plain, W_plain), evals + 2

        W_new, R_new, evals = jax.lax.cond(accept, accepted, fallback, None)

        # xi stopping residuals at the check stride (T(W_new) = W_new + R_new
        # is already known on both paths — the check costs ONE extra apply)
        if check_every == 1:
            err, derr = _residual_row(sp, W_new, _add(W_new, R_new), alpha)
            hist = hist.at[k].set(jnp.concatenate([err, derr]))
        else:
            checked = (k + 1) % check_every == 0
            err, derr = jax.lax.cond(
                checked,
                lambda: _residual_row(sp, W_new, _add(W_new, R_new), alpha),
                lambda: (err, derr))
            hist = hist.at[k].set(jnp.where(
                checked, jnp.concatenate([err, derr]), jnp.nan))

        slot = jnp.mod(pushes, memory)
        row = _sub(R_new, R)
        dR = _h_set(dR, slot, row)
        dW = _h_set(dW, slot, _sub(W_new, W))
        # rank-1 Gram maintenance: <new row, every row> fills the slot's
        # row and column (the diagonal entry rides along in both)
        g_row = _h_dot(_true(dR), _true(row))
        G = G.at[slot, :].set(g_row).at[:, slot].set(g_row)
        return (W_new, R_new, err, derr, dW, dR, G, k + 1, evals,
                pushes + 1, hist)

    out = jax.lax.while_loop(cond, body, state)
    W, err, k, evals, hist = out[0], out[2], out[7], out[8], out[10]
    return W[0], W[1], k, evals, err, hist


@partial(jax.jit, static_argnames=("max_iters", "memory", "ls_max",
                                   "check_every"))
@_precision
def run_cp_supermann(sp: StackedProblem, z0, eta0, x0, alpha, tol,
                     max_iters: int, memory: int = 5, ls_max: int = 1,
                     c0: float = 0.99, c1: float = 1.0, q_eps: float = 0.95,
                     beta: float = 0.5, check_every: int = 1):
    """SuperMann-style globalised quasi-Newton acceleration of the CP
    fixed point with limited-memory (type-I) Broyden directions.

    Directions approximate the inverse Jacobian of the residual map
    R(w) = w - T(w) with rank-one Broyden updates
    ``H+ = H + ((s - H y) y') / (y'y)``, kept in limited-memory SUM form
    ``H = I + sum_i u_i y_i'`` (apply and push are O(memory x dim)
    contractions, all on device, order-independent — so the histories are
    circular buffers, not rolls). Broyden — not L-BFGS — is the right
    quasi-Newton family here: the Jacobian of a primal-dual fixed-point
    residual is nonsymmetric, and this is the direction family the
    SuperMann paper itself pairs with the scheme (Themelis & Patrinos
    2019). Globalisation follows SuperMann's safe update rules:

    * **K0 (blind)**: while the residual keeps linearly decreasing
      (``|R w| <= c0 * eta_safe``), take the full quasi-Newton step.
    * **K1 (educated)**: otherwise backtrack ``tau`` until the candidate
      does not worsen the residual (``|R w_c| <= c1 |R w|``).
    * **Fallback**: if the line search fails, take the plain CP step
      ``w+ = T(w)`` — so the safeguarded iteration inherits plain CP's
      convergence (the reference algorithm without acceleration,
      reference ``solver.py:124-161``).

    ``c1`` defaults to 1.0 ("accept when not worse") for the same measured
    reason Anderson's safeguard moved to theta = 1.0 in round 4: the CP
    map contracts ~1e-4 per step near convergence, so demanding a strict
    0.99 contraction per accepted candidate rejects nearly everything —
    it measured 1.94 T-evals/iteration (every K1 candidate evaluated AND
    discarded for a plain step) and 11,150 iterations on the headline
    config. Not-worse acceptance
    plus the r_safe + summable-eps monotonicity envelope still rules out
    divergence. ``memory`` defaults to 5: each history row is a FULL
    extended vector, and the direction apply + Broyden push cost ~2 x
    memory passes over it per iteration — on a bandwidth-bound iteration
    the memory-10 histories alone tripled the per-step byte traffic.

    The hyperplane-projection (K2/GKM) update of full SuperMann is omitted
    deliberately: it is only Fejér-monotone in the CP preconditioner metric,
    not the Euclidean one used here; the K0/K1 + fallback subset is metric
    agnostic. Everything — histories, direction recursions, line search —
    stays on device inside one ``lax.while_loop``; points are extended
    vectors (see module docstring) so every candidate evaluation costs the
    plain step's two operator applies.

    Returns (z, eta, iters, t_evals, err, hist) with 6-column hist rows.
    """
    dt = sp.dtype
    z0, eta0 = Primal(*z0), Dual(*eta0)
    W0 = (z0, eta0, ell(sp, z0), ell_t(sp, eta0))
    T0 = _t_ext(sp, W0, alpha, x0)
    R0 = _sub(W0, T0)                      # residual R(w) = w - T(w)
    err0, derr0 = _residual_row(sp, W0, T0, alpha)
    nr0 = _norm(_true(R0))

    U = _h_zeros(W0, memory)               # Broyden vectors u_i (extended)
    Y = _h_zeros(W0, memory)               # y_i = r_{i+1} - r_i (extended)
    valid0 = jnp.zeros((memory,), dt)      # 1.0 = row in use
    hist = (jnp.zeros((max_iters + 1, 6), dt) if check_every == 1
            else jnp.full((max_iters + 1, 6), jnp.nan, dt))

    def _apply_h(U, Y, valid, V):
        """H v = v + sum_i u_i (y_i . v): inner products on the true
        components, combination over the extended rows."""
        w = _h_dot(_true(Y), _true(V)) * valid
        return _add(V, _h_combo(U, w))

    # carry: W, R, err/derr, U, Y, valid, eta_safe, r_safe, eps, slot,
    # k, evals, hist   (eta_safe gates K0; r_safe + summable eps gate K1)
    state = (W0, R0, err0, derr0, U, Y, valid0, nr0, nr0, nr0,
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(1, jnp.int32), hist)

    def cond(state):
        err, k = state[2], state[11]
        return jnp.logical_or(k == 0,
                              jnp.logical_and(jnp.max(err) > tol,
                                              k < max_iters + 1))

    def body(state):
        (W, R, err, derr, U, Y, valid, eta_safe, r_safe, eps, slot, k,
         evals, hist) = state
        norm_r = _norm(_true(R))

        d = _tmap(jnp.negative, _apply_h(U, Y, valid, R))

        def blind(_):
            # K0: accept w + d without a test; eta_safe tightens
            W_n = _add(W, d)
            T_n = _t_ext(sp, W_n, alpha, x0)
            return (W_n, _sub(W_n, T_n), norm_r, r_safe,
                    jnp.asarray(1, jnp.int32))

        def plain_step(j):
            # plain CP step w+ = T(w) = w - r (extended, free); refresh
            # the residual there with one T eval
            W_p = _sub(W, R)
            T_p = _t_ext(sp, W_p, alpha, x0)
            return W_p, _sub(W_p, T_p), eta_safe, r_safe, j + 1

        def line_search(_):
            # K1 is admissible only under the (loop-invariant) safeguard
            # |R w| <= r_safe; when it fails, no backtracking step can be
            # accepted, so go straight to the fallback instead of burning
            # ls_max T-map evaluations
            def attempt(_):
                # backtrack tau until |R(w + tau d)| <= c1 |R w|
                cand0 = (jnp.ones((), dt), W, R,
                         jnp.asarray(False), jnp.asarray(0, jnp.int32))

                def ls_cond(c):
                    tau, _, _, ok, j = c
                    return jnp.logical_and(jnp.logical_not(ok), j < ls_max)

                def ls_body(c):
                    tau, _, _, _, j = c
                    W_c = _add(W, _tmap(lambda v: tau * v, d))
                    T_c = _t_ext(sp, W_c, alpha, x0)
                    R_c = _sub(W_c, T_c)
                    ok = _norm(_true(R_c)) <= c1 * norm_r
                    return (tau * beta, W_c, R_c, ok, j + 1)

                tau, W_c, R_c, ok, j = jax.lax.while_loop(
                    ls_cond, ls_body, cand0)

                def accepted(_):
                    return (W_c, R_c, eta_safe,
                            _norm(_true(R_c)) + eps, j)

                return jax.lax.cond(ok, accepted,
                                    lambda _: plain_step(j), None)

            return jax.lax.cond(
                norm_r <= r_safe, attempt,
                lambda _: plain_step(jnp.asarray(0, jnp.int32)), None)

        W_n, R_n, eta_n, rsafe_n, ev = jax.lax.cond(
            norm_r <= c0 * eta_safe, blind, line_search, None)

        # Broyden push: u = (s - H y) / (y.y); skip degenerate pairs
        s = _sub(W_n, W)
        y = _sub(R_n, R)
        yy = tree_dot(_true(y), _true(y))
        good = yy > 1e-30
        Hy = _apply_h(U, Y, valid, y)
        u = _tmap(lambda si, hi: (si - hi) / jnp.where(good, yy, 1.0), s, Hy)
        gz = jnp.where(good, 1.0, 0.0).astype(dt)
        U = _h_set(U, slot, _tmap(lambda ui: ui * gz, u))
        Y = _h_set(Y, slot, y)
        valid = valid.at[slot].set(gz)
        slot = jnp.mod(slot + 1, memory)

        # xi stopping residuals at the check stride (T(W_n) = W_n - R_n)
        if check_every == 1:
            err, derr = _residual_row(sp, W_n, _sub(W_n, R_n), alpha)
            hist = hist.at[k].set(jnp.concatenate([err, derr]))
        else:
            checked = (k + 1) % check_every == 0
            err, derr = jax.lax.cond(
                checked,
                lambda: _residual_row(sp, W_n, _sub(W_n, R_n), alpha),
                lambda: (err, derr))
            hist = hist.at[k].set(jnp.where(
                checked, jnp.concatenate([err, derr]), jnp.nan))

        return (W_n, R_n, err, derr, U, Y, valid, eta_n, rsafe_n,
                eps * q_eps, slot, k + 1, evals + ev, hist)

    out = jax.lax.while_loop(cond, body, state)
    W, err, k, evals, hist = out[0], out[2], out[11], out[12], out[13]
    return W[0], W[1], k, evals, err, hist
