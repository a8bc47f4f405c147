"""Jitted ADMM QP solver with OSQP semantics.

The reference crosses Python -> C into OSQP for every SCP subproblem
(src/scp_solver.py:59-68: eps_abs = eps_rel = 1e-7, warm start, polish).
Here the same ADMM algorithm (Stellato et al., OSQP) runs as one XLA
program so it can be vmapped over scenario batches and sharded with pjit
-- no host round-trips inside the SCP loop.

Components mirrored from OSQP:
  * modified Ruiz equilibration (scaling matrices D, E, cost scale c);
  * per-constraint step sizes: rho_eq = 1e3 * rho on rows with l == u,
    rho / 1e3 on (-inf, inf) rows;
  * over-relaxation alpha, regularization sigma;
  * unscaled primal/dual residual termination with eps_abs/eps_rel;
  * adaptive rho with periodic refactorization;
  * optional warm starting of (x, y).

Batched-execution structure: the solver runs an outer `while_loop` over
SEGMENTS of `check_interval` plain ADMM iterations (an inner `fori_loop`
of pure matvec + backsolve work).  Residual evaluation and the adaptive-rho
refactorization happen only at segment boundaries.  This matters under
vmap: a `lax.cond` inside the hot loop lowers to `select` with BOTH
branches executed per iteration, which would turn the occasional Cholesky
refactorization into one per iteration; at segment granularity its cost is
amortized 1/check_interval.

Solution polish lives in the block solver (blockqp._polish: masked-ALM
iterative refinement + CG dual refinement -- the f32 route to the 1e-4
parity bar); this dense solver is the reference-layout path and adds
OSQP's primal/dual infeasibility certificates instead (see
`certificates` in solve_qp).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.solver.ocp import INF, QPData
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision

# Solver status codes (QPSolution.status / BlockQPSolution.status).
# MAX_ITER means the iteration budget ran out without meeting the
# tolerance OR certifying infeasibility; SOLVED mirrors `converged`.
STATUS_MAX_ITER = 0
STATUS_SOLVED = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3


@dataclasses.dataclass(frozen=True)
class QPSettings:
    """Static solver settings (OSQP defaults unless noted)."""

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-7   # reference src/scp_solver.py:63
    eps_rel: float = 1e-7
    max_iter: int = 20000
    check_interval: int = 25   # residual/adaptation cadence (OSQP default)
    scaling_iters: int = 10
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    # 'cond': refactor only when the prim/dual ratio leaves the deadband
    # (lax.cond -- cheap single-solve, but under vmap BOTH branches run
    # every check, costing a factorization per segment regardless).
    # 'always': unconditionally refactor at every residual check with the
    # deadbanded rho -- same math, vmap-friendly (one batched
    # factorization per check_interval, amortized over the segment).
    # Block solver only; the dense solver keeps its per-row cond path.
    adaptive_rho_mode: str = "cond"
    eq_rho_scale: float = 1e3
    # Block-solver factorization: 'cholesky' (blocked Cholesky with
    # pre-inverted factors; XLA sends the batched Cholesky and triangular
    # solves to cuSOLVER/cuBLAS; backward-stable, works everywhere) or
    # 'thomas' (Newton-Schulz Schur-complement inverses, matmul-only --
    # the inverse error compounds through the knot recursion and breaks
    # f32 convergence; CPU-validated, experimental).  Ignored by the
    # dense solver.
    factor_method: str = "cholesky"
    # Block-solver sweep lowering: 'scan' (sequential, throughput
    # default; on a GPU one fused kernel per backsolve,
    # ops/sweep_kernel.py, elsewhere XLA scans) or 'assoc' (log-depth
    # associative scan; fewer dependent steps for latency mode at ~V x
    # more FLOPs).  Ignored by the dense solver.
    sweep_method: str = "scan"
    # Block-solver solution polish (the OSQP polish step, reference
    # src/scp_solver.py:62, as a masked active-set ALM — see
    # blockqp._polish).  One extra factorization + polish_iters sweeps
    # after termination; the polished iterate is kept only if it improves
    # max(prim, dual).  Lets the main loop run at loose eps while
    # delivering tight-solution quality.  Ignored by the dense solver.
    polish: bool = False
    polish_rho: float = 1e3
    polish_iters: int = 12
    polish_active_tol: float = 1e-3
    # Proximal regularization of the polish factorization only (the
    # polish fixed point is sigma-independent -- see blockqp._polish).
    # Sized so cond(M) ~ polish_rho / polish_sigma keeps
    # cond * eps_f32 well below 1 (refinement contracts) while staying
    # small against P's weakest curvature (prox directions contract by
    # ~sigma/(sigma + lambda_min)).  Measured on the N=50 trot QP in
    # f32 (2026-08-21, vs a 1e-9 f64 reference): (1e3, 1e-3, 12 iters,
    # 2 rounds) reaches u_err 5.5e-5 / x_err 3.0e-6 from a 90-iteration
    # eps=5e-4 solve -- the BASELINE 1e-4 parity bar; larger
    # sigma stalls the prox contraction, smaller diverges the f32
    # refinement (and is rejected by accept-if-improves).
    polish_sigma: float = 1e-3
    # Active-set re-detection rounds: at loose main-loop eps the first
    # detection can mislabel weakly-active rows; each round re-detects
    # from the polished iterate (one extra factorization per round).
    polish_rounds: int = 2
    # Per-round multiplier of (polish_rho, polish_sigma): the ALM
    # multiplier iteration contracts like 1/(1 + rho*lambda) per active-
    # row eigendirection, so near-degenerate directions need larger rho;
    # ramping keeps round 1 f32-conservative and sharpens later rounds
    # at constant cond(M).
    polish_rho_ramp: float = 1.0
    # Dual refinement: CG iterations on the ALM-preconditioned dual
    # normal equations S dy = -A M^-1 g (see blockqp._polish).  The ALM
    # y-update is Richardson iteration on the same system and leaves
    # the dual residual O(1) on near-degenerate active-row directions;
    # CG converges those in ~15 iterations (measured: dual 1.9 -> 0.03
    # on the N=50 trot QP).  The refined dual is carried as a TWO-FLOAT
    # (hi, lo) pair between restart phases and through the final
    # residual evaluation (blockqp._two_sum): the scaled equality duals
    # sit at O(1e2) while the eps=1e-5 tier must resolve the dual
    # residual at O(1e-5), so one f32 ulp of y is the size of the whole
    # residual -- the round-4 "f32 dual floor" (success_frac 0.922) was
    # this storage/measurement precision, not the Krylov solver (the
    # dual least-squares optimum over the same detected active rows
    # sits at ~1e-7 scaled, benchmarks/_probe_lsq.py).  With the
    # two-float dual the same CG budget certifies 128/128 lanes at
    # eps=1e-5, SURVEY section 7c's "f64 islands" hard part
    # done at pure-f32 cost (one extra A' application per restart).
    # 0 disables.
    polish_cg_iters: int = 15
    # CG restart phases with a freshly-evaluated residual (the f32
    # recurrence drift caps a single phase at ~3e-2 scaled dual).
    polish_cg_restarts: int = 2
    # Stall exit (block solver): leave the ADMM loop early when the
    # best-so-far max(prim, dual) has not improved by >= 1% for this
    # many consecutive residual checks -- an f32 iterate at its
    # arithmetic floor makes no further progress, and with polish on
    # the refinement pass closes the remaining gap far cheaper than
    # burning max_iter.  0 disables (run to tolerance or max_iter).
    stall_segments: int = 0
    # OSQP primal/dual infeasibility certificates (delta-y / delta-x
    # tests at every residual check; see blockqp._certificates).  An
    # infeasible QP exits with a distinct status in well under the
    # iteration budget instead of burning max_iter (the reference aborts
    # its SCP loop on OSQP's version of these statuses,
    # src/scp_solver.py:59-68).
    check_infeasibility: bool = True
    eps_pinf: float = 1e-4   # OSQP eps_prim_inf default
    eps_dinf: float = 1e-4   # OSQP eps_dual_inf default


class QPSolution(struct.PyTreeNode):
    x: jnp.ndarray          # primal solution (unscaled)
    y: jnp.ndarray          # dual solution (unscaled)
    z: jnp.ndarray          # projected constraint values
    iterations: jnp.ndarray
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    converged: jnp.ndarray  # bool
    status: jnp.ndarray     # int32 STATUS_*


def ruiz_equilibrate(qp: QPData, iters: int):
    """Modified Ruiz equilibration of [[P, A'], [A, 0]] with cost scaling.

    Returns (scaled QPData, D (n,), E (m,), c scalar).  All-zero rows or
    columns scale by 1 (guarded).
    """
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    n, m = P.shape[0], A.shape[0]
    dtype = P.dtype
    D = jnp.ones(n, dtype)
    E = jnp.ones(m, dtype)
    c = jnp.ones((), dtype)

    def body(_, carry):
        P, q, A, D, E, c = carry
        col_norm = jnp.maximum(jnp.abs(P).max(axis=0), jnp.abs(A).max(axis=0))
        d = 1.0 / jnp.sqrt(jnp.where(col_norm > 0, col_norm, 1.0))
        row_norm = jnp.abs(A).max(axis=1)
        e = 1.0 / jnp.sqrt(jnp.where(row_norm > 0, row_norm, 1.0))
        P = d[:, None] * P * d[None, :]
        A = e[:, None] * A * d[None, :]
        q = d * q
        # cost normalization (OSQP): gamma = 1/max(mean col norm P, |q|_inf)
        p_cols = jnp.abs(P).max(axis=0).mean()
        gamma_den = jnp.maximum(p_cols, jnp.abs(q).max())
        gamma = 1.0 / jnp.where(gamma_den > 0, gamma_den, 1.0)
        P, q, c = P * gamma, q * gamma, c * gamma
        return P, q, A, D * d, E * e, c

    P, q, A, D, E, c = jax.lax.fori_loop(0, iters, body, (P, q, A, D, E, c))
    l = jnp.clip(E * l, -INF, INF)
    u = jnp.clip(E * u, -INF, INF)
    return QPData(P=P, q=q, A=A, l=l, u=u), D, E, c


def _rho_vector(l, u, rho, settings: QPSettings):
    eq = (u - l) < 1e-10
    loose = (l <= -INF) & (u >= INF)
    return jnp.where(eq, settings.eq_rho_scale * rho,
                     jnp.where(loose, rho / settings.eq_rho_scale, rho))


@highest_precision
def solve_qp(qp: QPData, settings: QPSettings = QPSettings(),
             x0=None, y0=None) -> QPSolution:
    """Solve min 1/2 x'Px + q'x s.t. l <= Ax <= u.  Jittable/vmappable."""
    n, m = qp.P.shape[0], qp.A.shape[0]
    dtype = qp.P.dtype
    scaled, D, E, c = ruiz_equilibrate(qp, settings.scaling_iters)
    P, q, A, l, u = scaled.P, scaled.q, scaled.A, scaled.l, scaled.u
    sigma = jnp.asarray(settings.sigma, dtype)
    n_segments = -(-settings.max_iter // settings.check_interval)

    def factor(rho_scalar):
        rho_vec = _rho_vector(l, u, rho_scalar, settings)
        M = (P + sigma * jnp.eye(n, dtype=dtype)
             + (A.T * rho_vec[None, :]) @ A)
        return jnp.linalg.cholesky(M), rho_vec

    rho0 = jnp.asarray(settings.rho, dtype)
    chol, rho_vec = factor(rho0)

    # Warm start in scaled space: x_unscaled = D x_scaled, y_unscaled = E y/c.
    x = jnp.zeros(n, dtype) if x0 is None else x0 / D
    y = jnp.zeros(m, dtype) if y0 is None else c * y0 / E
    z = A @ x

    def chol_solve(L, b):
        w = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, w, lower=False)

    def admm_iter(_, state):
        x, z, y, rho_vec, L = state
        rhs = sigma * x - q + A.T @ (rho_vec * z - y)
        x_t = chol_solve(L, rhs)
        z_t = A @ x_t
        x_new = settings.alpha * x_t + (1 - settings.alpha) * x
        z_relaxed = settings.alpha * z_t + (1 - settings.alpha) * z
        z_new = jnp.clip(z_relaxed + y / rho_vec, l, u)
        y_new = y + rho_vec * (z_relaxed - z_new)
        return x_new, z_new, y_new, rho_vec, L

    def certificates(dx, dy):
        """OSQP primal/dual infeasibility tests (sec. 3.4) on a segment's
        iterate deltas, against the unscaled problem (candidates
        ybar = E dy, xbar = D dx; positive scalars dropped)."""
        y_norm = jnp.abs(E * dy).max()
        atdy = jnp.abs((A.T @ dy) / D).max()
        eps_p = settings.eps_pinf * y_norm
        # support over finite bounds only; infinite-bound rows need the
        # recession-feasible dy sign within eps (OSQP convention)
        fin_ur = (u / E) < 0.5 * INF
        fin_lr = (l / E) > -0.5 * INF
        sup = jnp.sum(jnp.where(fin_ur, u * jnp.maximum(dy, 0.0), 0.0)
                      + jnp.where(fin_lr, l * jnp.minimum(dy, 0.0), 0.0))
        sign_ok = (jnp.all(fin_ur | (E * dy <= eps_p))
                   & jnp.all(fin_lr | (E * dy >= -eps_p)))
        pinf = (y_norm > 0) & (atdy <= eps_p) & sign_ok & (sup <= -eps_p)

        x_norm = jnp.abs(D * dx).max()
        pdx = jnp.abs((P @ dx) / D).max() / c
        qdx = jnp.dot(q, dx) / c
        adx = (A @ dx) / E
        eps_d = settings.eps_dinf * x_norm
        fin_u = (u / E) < 0.5 * INF
        fin_l = (l / E) > -0.5 * INF
        cone_ok = (jnp.all(~fin_u | (adx <= eps_d))
                   & jnp.all(~fin_l | (adx >= -eps_d)))
        dinf = (x_norm > 0) & (pdx <= eps_d) & (qdx <= -eps_d) & cone_ok
        return pinf, dinf

    def segment(carry):
        x0_, z, y0_, rho_scalar, rho_vec, L, it, _, _, _, _, best = carry
        x, z, y, rho_vec, L = jax.lax.fori_loop(
            0, settings.check_interval, admm_iter, (x0_, z, y0_, rho_vec, L))
        it = it + settings.check_interval

        # Unscaled residuals (OSQP sec. 5.1), once per segment.
        Ax = A @ x
        Px = P @ x
        Aty = A.T @ y
        prim = jnp.abs((Ax - z) / E).max()
        dual = jnp.abs((Px + q + Aty) / D).max() / c
        prim_scale = jnp.maximum(jnp.abs(Ax / E).max(), jnp.abs(z / E).max())
        dual_scale = jnp.maximum(
            jnp.maximum(jnp.abs(Px / D).max(), jnp.abs(Aty / D).max()),
            jnp.abs(q / D).max()) / c
        eps_prim = settings.eps_abs + settings.eps_rel * prim_scale
        eps_dual = settings.eps_abs + settings.eps_rel * dual_scale
        done = (prim < eps_prim) & (dual < eps_dual)
        status = jnp.where(done, STATUS_SOLVED,
                           STATUS_MAX_ITER).astype(jnp.int32)
        if settings.check_infeasibility:
            pinf, dinf = certificates(x - x0_, y - y0_)
            status = jnp.where(
                pinf & ~done, STATUS_PRIMAL_INFEASIBLE,
                jnp.where(dinf & ~done, STATUS_DUAL_INFEASIBLE,
                          status)).astype(jnp.int32)
            done = done | ((pinf | dinf) & ~done)

        # best-so-far safeguard (see blockqp): a stalled/drifting f32
        # iterate never worsens the returned solution
        xb, zb, yb, pb, db = best
        improve = jnp.maximum(prim, dual) < jnp.maximum(pb, db)
        take = lambda new, old: jnp.where(improve, new, old)
        best = (take(x, xb), take(z, zb), take(y, yb),
                jnp.where(improve, prim, pb), jnp.where(improve, dual, db))

        if settings.adaptive_rho:
            # OSQP adaptive rho at segment granularity.  NOTE: under vmap,
            # lax.cond lowers to both-branches execution, so the batched
            # throughput path should run with adaptive_rho=False (Ruiz
            # scaling + fixed rho + warm starts); adaptive rho is for
            # unbatched high-accuracy solves where cond stays lazy.
            ratio = jnp.sqrt(
                (prim / jnp.maximum(prim_scale, 1e-30))
                / jnp.maximum(dual / jnp.maximum(dual_scale, 1e-30), 1e-30))
            new_rho = jnp.clip(rho_scalar * ratio, 1e-6, 1e6)
            trigger = ((ratio > settings.adaptive_rho_tol)
                       | (ratio < 1.0 / settings.adaptive_rho_tol)) & ~done

            def refactor(_):
                L2, rv2 = factor(new_rho)
                return new_rho, rv2, L2

            rho_scalar, rho_vec, L = jax.lax.cond(
                trigger, refactor, lambda _: (rho_scalar, rho_vec, L), None)

        return (x, z, y, rho_scalar, rho_vec, L, it, prim, dual, done,
                status, best)

    def cond(carry):
        _, _, _, _, _, _, it, _, _, done, _, _ = carry
        return (~done) & (it < n_segments * settings.check_interval)

    inf0 = jnp.asarray(jnp.inf, dtype)
    best0 = (x, z, y, inf0, inf0)
    init = (x, z, y, rho0, rho_vec, chol, jnp.zeros((), jnp.int32),
            inf0, inf0, jnp.asarray(False), jnp.zeros((), jnp.int32),
            best0)
    (x, z, y, _, _, _, it, prim, dual, done, status,
     (xb, zb, yb, pb, db)) = jax.lax.while_loop(cond, segment, init)
    adopt = jnp.maximum(pb, db) < jnp.maximum(prim, dual)
    takeb = lambda a, b: jnp.where(adopt, a, b)
    x, z, y = takeb(xb, x), takeb(zb, z), takeb(yb, y)
    prim = jnp.where(adopt, pb, prim)
    dual = jnp.where(adopt, db, dual)
    del done  # loop-exit flag; includes infeasible exits
    status = jnp.asarray(status, jnp.int32)
    return QPSolution(x=D * x, y=E * y / c, z=z / E, iterations=it,
                      prim_res=prim, dual_res=dual,
                      converged=(status == STATUS_SOLVED), status=status)
