"""Jitted DDP/iLQR trajectory optimizer.

Replaces the reference's Crocoddyl SolverFDDP stages (whole-body warm start
and tracking, src/whole_body_control.py + run_motion.py:24-27, :56-61) with
a TPU-native solver: the backward Riccati sweep is a `lax.scan`, stage
derivatives are vmapped AD over all knots at once, the line search
evaluates ALL candidate step sizes in parallel (vmapped rollouts) instead
of sequential backtracking, and the SPD Quu solves use the matmul-only
Newton-Schulz inverse.  The whole solve is one XLA program: jit/vmap/shard
compatible.

This is a generic solver over user-supplied `dynamics(x, u, k)`,
`stage_cost(x, u, k)`, `terminal_cost(x)`; solver/warm_start.py uses it on
the centroidal dynamics to produce dynamically-consistent warm starts (the
reference's stage-1 DDP role); a joint-space whole-body model can plug in
the same solver.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.ops.linalg import spd_inverse
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class DdpSettings:
    iterations: int = 20
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 0.5
    reg_min: float = 1e-9
    reg_max: float = 1e6
    # parallel line-search step sizes (Crocoddyl uses backtracking over a
    # similar ladder; here all candidates roll out at once under vmap)
    n_alphas: int = 8
    tol_grad: float = 1e-9
    # Quu solver: the matmul-only Newton-Schulz inverse (False) is the TPU
    # fast path but stalls on ill-conditioned Quu (e.g. whole-body torque
    # problems where tiny distal-link inertias make Quu anisotropic);
    # True uses an exact LU solve.
    exact_quu: bool = False


class DdpSolution(struct.PyTreeNode):
    X: jnp.ndarray           # (N+1, nx)
    U: jnp.ndarray           # (N, nu)
    K: jnp.ndarray           # (N, nu, nx) feedback gains of last backward pass
    cost: jnp.ndarray
    iterations: jnp.ndarray
    reg: jnp.ndarray
    improved: jnp.ndarray    # bool: last iteration reduced the cost


def solve_ilqr(dynamics: Callable, stage_cost: Callable,
               terminal_cost: Callable, x0: jnp.ndarray, U0: jnp.ndarray,
               settings: DdpSettings = DdpSettings()) -> DdpSolution:
    """iLQR with regularized Riccati backward pass and parallel line search.

    dynamics(x, u, k) -> x_next; stage_cost(x, u, k) -> scalar;
    terminal_cost(x) -> scalar.  All jittable.
    """

    def derivatives(X, U, ks):
        fx = jax.vmap(jax.jacfwd(dynamics, argnums=0))(X[:-1], U, ks)
        fu = jax.vmap(jax.jacfwd(dynamics, argnums=1))(X[:-1], U, ks)
        lx = jax.vmap(jax.grad(stage_cost, argnums=0))(X[:-1], U, ks)
        lu = jax.vmap(jax.grad(stage_cost, argnums=1))(X[:-1], U, ks)
        lxx = jax.vmap(jax.hessian(stage_cost, argnums=0))(X[:-1], U, ks)
        luu = jax.vmap(jax.hessian(stage_cost, argnums=1))(X[:-1], U, ks)
        lux = jax.vmap(jax.jacfwd(jax.grad(stage_cost, argnums=1),
                                  argnums=0))(X[:-1], U, ks)
        vx_T = jax.grad(terminal_cost)(X[-1])
        vxx_T = jax.hessian(terminal_cost)(X[-1])
        return fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T

    return _solve_core(dynamics, stage_cost, terminal_cost, derivatives,
                       x0, U0, settings)


def solve_ilqr_residual(dynamics: Callable, stage_residual: Callable,
                        terminal_residual: Callable, x0: jnp.ndarray,
                        U0: jnp.ndarray,
                        settings: DdpSettings = DdpSettings(),
                        X_init: jnp.ndarray | None = None) -> DdpSolution:
    """Gauss-Newton iLQR over least-squares costs (Crocoddyl's residual
    models, reference src/whole_body_control.py:46-152).

    stage_residual(x, u, k) -> (nr,); terminal_residual(x) -> (nrT,);
    cost = sum_k r_k @ r_k + r_T @ r_T.  The backward pass uses the
    Gauss-Newton Hessian 2 J'J instead of exact second derivatives —
    guaranteed PSD and a much smaller XLA graph than `jax.hessian`
    through contact-KKT dynamics (one fused jacfwd over z = [x, u] per
    knot yields dynamics AND residual jacobians in a single batch of
    forward-mode tangents).

    X_init (N+1, nx): optional *state-trajectory* warm start that need NOT
    be a rollout of U0 -- enables the FDDP multiple-shooting mode (gap
    handling, see _solve_core), the reference's SolverFDDP.solve(xs, us)
    semantics (run_motion.py:24-27).  Without it the open-loop rollout of
    U0 is the start (pure iLQR), which diverges on unstable gaits (e.g.
    solo12 bound at full step length) where Crocoddyl's xs warm start is
    what makes the problem solvable."""
    nx = x0.shape[0]

    def stage_cost(x, u, k):
        r = stage_residual(x, u, k)
        return r @ r

    def terminal_cost(x):
        r = terminal_residual(x)
        return r @ r

    def derivatives(X, U, ks):
        def knot(x, u, k):
            def g(z):
                return (dynamics(z[:nx], z[nx:], k),
                        stage_residual(z[:nx], z[nx:], k))
            z = jnp.concatenate([x, u])
            jf, jr = jax.jacfwd(g)(z)
            r = stage_residual(x, u, k)
            lx = 2.0 * jr[:, :nx].T @ r
            lu = 2.0 * jr[:, nx:].T @ r
            lxx = 2.0 * jr[:, :nx].T @ jr[:, :nx]
            luu = 2.0 * jr[:, nx:].T @ jr[:, nx:]
            lux = 2.0 * jr[:, nx:].T @ jr[:, :nx]
            return jf[:, :nx], jf[:, nx:], lx, lu, lxx, luu, lux

        fx, fu, lx, lu, lxx, luu, lux = jax.vmap(knot)(X[:-1], U, ks)
        r_t = terminal_residual(X[-1])
        j_t = jax.jacfwd(terminal_residual)(X[-1])
        vx_T = 2.0 * j_t.T @ r_t
        vxx_T = 2.0 * j_t.T @ j_t
        return fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T

    return _solve_core(dynamics, stage_cost, terminal_cost, derivatives,
                       x0, U0, settings, X_init=X_init)


@highest_precision
def _solve_core(dynamics: Callable, stage_cost: Callable,
                terminal_cost: Callable, derivatives: Callable,
                x0: jnp.ndarray, U0: jnp.ndarray,
                settings: DdpSettings,
                X_init: jnp.ndarray | None = None) -> DdpSolution:
    """iLQR core; with X_init it becomes FDDP (multiple shooting).

    FDDP mode (Crocoddyl SolverFDDP semantics): the iterate (X, U) may be
    dynamically infeasible with per-transition gaps
    d_k = f(x_k, u_k) - x_{k+1}.  The backward pass propagates the value
    function THROUGH the gaps (vx <- vx + vxx d_k); the forward pass
    contracts them, x_{k+1} = f(x_hat_k, u_k) - (1-alpha) d_k, so an
    alpha step leaves gaps scaled by (1-alpha).  Acceptance uses a merit
    function cost + mu * ||d||_1 (mu fixed from the initial iterate), so
    gap closure can buy a temporary cost increase -- what makes unstable
    gaits (bound at full step length) solvable from a kinematic state
    warm start where a pure-iLQR open-loop rollout is NaN by knot 20.
    """
    N, nu = U0.shape
    nx = x0.shape[0]
    dtype = x0.dtype
    ks = jnp.arange(N)
    alphas = 2.0 ** (-jnp.arange(settings.n_alphas, dtype=dtype))
    fddp = X_init is not None

    def rollout(U):
        def step(x, inputs):
            u, k = inputs
            xn = dynamics(x, u, k)
            return xn, xn
        _, xs = jax.lax.scan(step, x0, (U, ks))
        return jnp.concatenate([x0[None], xs], axis=0)

    def total_cost(X, U):
        return (jax.vmap(stage_cost)(X[:-1], U, ks).sum()
                + terminal_cost(X[-1]))

    def gaps_of(X, U):
        return jax.vmap(dynamics)(X[:-1], U, ks) - X[1:]

    def backward(derivs, gaps, reg):
        fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T = derivs

        def step(carry, inputs):
            vx, vxx = carry
            fx_k, fu_k, lx_k, lu_k, lxx_k, luu_k, lux_k, d_k = inputs
            # FDDP gap term: the value gradient seen across transition k
            # is evaluated at f(x_k,u_k) = x_{k+1} + d_k
            vx_g = vx + vxx @ d_k
            qx = lx_k + fx_k.T @ vx_g
            qu = lu_k + fu_k.T @ vx_g
            qxx = lxx_k + fx_k.T @ vxx @ fx_k
            quu = luu_k + fu_k.T @ vxx @ fu_k + reg * jnp.eye(nu, dtype=dtype)
            qux = lux_k + fu_k.T @ vxx @ fx_k
            quu_inv = (jnp.linalg.inv(quu) if settings.exact_quu
                       else spd_inverse(quu))
            k_ff = -quu_inv @ qu
            k_fb = -quu_inv @ qux
            vx_new = qx + k_fb.T @ quu @ k_ff + k_fb.T @ qu + qux.T @ k_ff
            vxx_new = qxx + k_fb.T @ quu @ k_fb + k_fb.T @ qux + qux.T @ k_fb
            vxx_new = 0.5 * (vxx_new + vxx_new.T)
            return (vx_new, vxx_new), (k_ff, k_fb, qu)

        (_, _), (k_ff, k_fb, qu) = jax.lax.scan(
            step, (vx_T, vxx_T), (fx, fu, lx, lu, lxx, luu, lux, gaps),
            reverse=True)
        grad_norm = jnp.abs(qu).max()
        return k_ff, k_fb, grad_norm

    def forward(X_bar, U_bar, gaps, k_ff, k_fb, alpha):
        def step(x, inputs):
            xb, ub, kf, kb, d, k = inputs
            u = ub + alpha * kf + kb @ (x - xb)
            xn = dynamics(x, u, k) - (1.0 - alpha) * d
            return xn, (xn, u)
        _, (xs, us) = jax.lax.scan(
            step, x0, (X_bar[:-1], U_bar, k_ff, k_fb, gaps, ks))
        return jnp.concatenate([x0[None], xs], axis=0), us

    class Carry(struct.PyTreeNode):
        X: jnp.ndarray
        U: jnp.ndarray
        K: jnp.ndarray
        cost: jnp.ndarray
        gapnorm: jnp.ndarray
        reg: jnp.ndarray
        it: jnp.ndarray
        improved: jnp.ndarray
        done: jnp.ndarray

    if fddp:
        X_start = jnp.asarray(X_init, dtype).at[0].set(x0)
    else:
        X_start = rollout(U0)
    cost0 = total_cost(X_start, U0)
    gap0 = jnp.abs(gaps_of(X_start, U0)).sum() if fddp else jnp.zeros(
        (), dtype)
    # merit weight: gap closure worth ~10x the initial cost-per-unit-gap
    mu = 10.0 * (jnp.abs(cost0) + 1.0) / (gap0 + 1e-9) if fddp else 0.0

    init = Carry(X=X_start, U=U0,
                 K=jnp.zeros((N, nu, nx), dtype),
                 cost=cost0, gapnorm=gap0,
                 reg=jnp.asarray(settings.reg_init, dtype),
                 it=jnp.zeros((), jnp.int32),
                 improved=jnp.asarray(True),
                 done=jnp.asarray(False))

    def body(c: Carry):
        derivs = derivatives(c.X, c.U, ks)
        gaps = (gaps_of(c.X, c.U) if fddp
                else jnp.zeros((N, nx), dtype))
        k_ff, k_fb, grad_norm = backward(derivs, gaps, c.reg)
        # all candidate step sizes roll out in parallel
        Xs, Us = jax.vmap(
            lambda a: forward(c.X, c.U, gaps, k_ff, k_fb, a))(alphas)
        costs = jax.vmap(total_cost)(Xs, Us)
        costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
        if fddp:
            gapnorms = (1.0 - alphas) * c.gapnorm
            merits = costs + mu * gapnorms
            merit_cur = c.cost + mu * c.gapnorm
        else:
            gapnorms = jnp.zeros_like(costs)
            merits = costs
            merit_cur = c.cost
        best = jnp.argmin(merits)
        improved = merits[best] < merit_cur - 1e-12
        X_new = jnp.where(improved, Xs[best], c.X)
        U_new = jnp.where(improved, Us[best], c.U)
        cost_new = jnp.where(improved, costs[best], c.cost)
        gap_new = jnp.where(improved, gapnorms[best], c.gapnorm)
        reg = jnp.clip(
            jnp.where(improved, c.reg * settings.reg_decrease,
                      c.reg * settings.reg_increase),
            settings.reg_min, settings.reg_max)
        done = ((grad_norm < settings.tol_grad) & (gap_new < 1e-9)) | (
            ~improved & (c.reg >= settings.reg_max))
        return Carry(X=X_new, U=U_new, K=k_fb, cost=cost_new,
                     gapnorm=gap_new, reg=reg,
                     it=c.it + 1, improved=improved, done=done)

    def cond(c: Carry):
        return (c.it < settings.iterations) & ~c.done

    c = jax.lax.while_loop(cond, body, init)
    return DdpSolution(X=c.X, U=c.U, K=c.K, cost=c.cost, iterations=c.it,
                       reg=c.reg, improved=c.improved)
