"""Structure-exploiting ADMM QP solver on per-knot blocks.

This is the production path.  The dense solver (ops/admm.py) carries
O(n^2) matrices (n ~ 1160 for N=50) through every iteration -- at ~0.85
FLOP/byte it is bound by device-memory bandwidth.  This module solves
the *same* QP (same math contract, OSQP-style ADMM, Ruiz scaling,
per-row rho) but never materializes a dense matrix:

  * decision variables stay shaped per knot: W = (N+1, V) with
    V = nx + nu + 1 (state, control, trust slack; the control slot of the
    terminal knot is a padded dummy);
  * the constraint operator A is applied as batched einsums over knots
    (linearized dynamics blocks, rotated friction pyramids, sign-enumerated
    trust rows) -- O(N * V^2) work and bytes per application;
  * the ADMM normal matrix M = P + sigma I + A' diag(rho) A is
    block-tridiagonal in the knots; it is factorized once per solve by a
    blocked Cholesky (scan over knots, V x V blocks) and each iteration
    performs one forward/backward block sweep.

Per-iteration state is ~100x smaller than the dense path, which moves the
throughput ceiling from HBM bandwidth to compute.  All loops are scans,
everything vmaps over scenario batches.

Supports both POINT3 robots (solo12, bolt) and WRENCH6 humanoids (talos):
per-contact controls have width nuc (3 or 6), the rotated pyramid acts on
the force columns within each contact slice, and WRENCH6 adds the per-knot
CoP box rows (reference src/constraints.py:111-145) as their own group.

Reference semantics preserved: decision layout and row meaning follow
src/optimizer.py / src/constraints.py; dynamics rows carry the +-1e-12
feasibility slack; the unilateral pyramid row stays empty unless
`fill_unilateral` (src/constraints.py:180).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import (CentroidalModel, N_X,
                                                  TrajectoryData)
from centroidal_mpc_tpu.ops.admm import (QPSettings, STATUS_MAX_ITER,
                                         STATUS_SOLVED,
                                         STATUS_PRIMAL_INFEASIBLE,
                                         STATUS_DUAL_INFEASIBLE)
from centroidal_mpc_tpu.ops.sweep_kernel import block_tridiag_sweep
from centroidal_mpc_tpu.solver.ocp import (DYN_SLACK, INF, OcpConfig,
                                           sign_enumeration_matrix)
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision


class BlockQP(struct.PyTreeNode):
    """Block-structured QP data (unscaled).

    Cost: 1/2 x'Wx x + qx'x per state knot, 1/2 u'Wu u + qu'u per control
    knot, qt' t on trust slacks.  Constraints per group:
      init:  x_0 = x_init (+- 0)
      dyn:   A_k x_k + B_k u_k - x_{k+1} = r_k (+- DYN_SLACK)
      final: x_N = x_final
      fric:  G_kcr . u_force <= fric_ub   (5 rows/contact, inner pyramid)
      trust: penum x_ang - t/omega <= trust_ub
      slack: -t <= 0
    """

    Wx: jnp.ndarray        # (nx, nx) state cost block (shared across knots)
    Wu: jnp.ndarray        # (nu, nu)
    qx: jnp.ndarray        # (N+1, nx)
    qt: jnp.ndarray        # (N+1,)
    A: jnp.ndarray         # (N, nx, nx)
    B: jnp.ndarray         # (N, nx, nu)
    r_dyn: jnp.ndarray     # (N, nx)
    x_init: jnp.ndarray    # (nx,)
    final_l: jnp.ndarray   # (nx,) terminal bounds (equal for the
    final_u: jnp.ndarray   # reference's hard terminal state; +-INF for MPC)
    G: jnp.ndarray         # (N, C, 5, nuc) rotated, logic-gated pyramid
                           # acting on each contact's control slice
    fric_ub: jnp.ndarray   # (N, C, 5)
    cop_act: jnp.ndarray   # (N, C, 2) CoP row coefficients (wrench6: the
                           # contact logic; point3: zeros -> inert rows)
    cop_l: jnp.ndarray     # (N, C, 2)
    cop_u: jnp.ndarray     # (N, C, 2)
    penum: jnp.ndarray     # (8, 3)
    inv_omega: jnp.ndarray # scalar 1/omega
    trust_ub: jnp.ndarray  # (N+1, 8)

    @property
    def horizon(self) -> int:
        return self.A.shape[0]

    @property
    def n_u(self) -> int:
        return self.B.shape[2]


@highest_precision
def build_block_qp(model: CentroidalModel, schedule: ContactSchedule,
                   cfg: OcpConfig, X_prev: jnp.ndarray, U_prev: jnp.ndarray,
                   data: TrajectoryData, radius, weight) -> BlockQP:
    """Assemble the block QP (same math as solver.ocp.build_qp)."""
    dtype = X_prev.dtype
    nuc = model.n_u_per_contact
    rot_pyr = jnp.einsum("ri,kcji->kcrj", cfg.pyramid, schedule.orientation)
    rot_pyr = rot_pyr * schedule.logic[:, :, None, None]
    if not cfg.fill_unilateral:
        rot_pyr = rot_pyr.at[:, :, 4, :].set(0.0)
    N, C = rot_pyr.shape[0], rot_pyr.shape[1]
    fric_ub = jnp.zeros((N, C, 5), dtype)
    if cfg.stochastic:
        from centroidal_mpc_tpu.solver.ocp import _chance_backoffs
        fric_ub = fric_ub - _chance_backoffs(model, cfg, data, rot_pyr)
    if nuc == 3:
        G = rot_pyr
        cop_act = jnp.zeros((N, C, 2), dtype)
        cop_l = jnp.zeros((N, C, 2), dtype)
        cop_u = jnp.zeros((N, C, 2), dtype)
    else:  # wrench6: forces sit at columns 2:5; CoP box on columns 0:2
        G = jnp.zeros((N, C, 5, nuc), dtype).at[:, :, :, 2:5].set(rot_pyr)
        cop_act = jnp.broadcast_to(schedule.logic[:, :, None], (N, C, 2))
        lo = jnp.stack([-cfg.cop_range[0, 1], -cfg.cop_range[1, 1]])
        hi = jnp.stack([cfg.cop_range[0, 0], cfg.cop_range[1, 0]])
        cop_l = jnp.where(cop_act > 0, lo, 0.0)
        cop_u = jnp.where(cop_act > 0, hi, 0.0)
    qx = (-(cfg.X_track @ cfg.Wx.T) if cfg.track_state
          else jnp.zeros_like(X_prev))
    penum = sign_enumeration_matrix(3, dtype)
    r_dyn = (jnp.einsum("kij,kj->ki", data.A, X_prev[:-1])
             + jnp.einsum("kij,kj->ki", data.B, U_prev) - data.f)
    return BlockQP(
        Wx=cfg.Wx, Wu=cfg.Wu, qx=qx,
        qt=jnp.ones(N + 1, dtype),
        A=data.A, B=data.B, r_dyn=r_dyn,
        x_init=cfg.x_init,
        final_l=(cfg.x_final if cfg.terminal_equality
                 else jnp.full_like(cfg.x_final, -INF)),
        final_u=(cfg.x_final if cfg.terminal_equality
                 else jnp.full_like(cfg.x_final, INF)),
        G=G, fric_ub=fric_ub, cop_act=cop_act, cop_l=cop_l, cop_u=cop_u,
        penum=penum,
        inv_omega=1.0 / jnp.asarray(weight, dtype),
        trust_ub=radius + X_prev[:, 6:9] @ penum.T,
    )


class ZGroups(NamedTuple):
    """Constraint-space vector, grouped by row family (the reference row
    ordering: initial, dynamics, final, cop, friction, trust, slack)."""

    init: jnp.ndarray    # (nx,)
    dyn: jnp.ndarray     # (N, nx)
    final: jnp.ndarray   # (nx,)
    cop: jnp.ndarray     # (N, C, 2) -- zero rows for point3 robots
    fric: jnp.ndarray    # (N, C, 5)
    trust: jnp.ndarray   # (N+1, 8)
    slack: jnp.ndarray   # (N+1,)


def zero_zgroups(N: int, C: int, dtype) -> ZGroups:
    """Zero constraint-space vector (e.g. a cold dual warm start)."""
    return ZGroups(init=jnp.zeros((N_X,), dtype),
                   dyn=jnp.zeros((N, N_X), dtype),
                   final=jnp.zeros((N_X,), dtype),
                   cop=jnp.zeros((N, C, 2), dtype),
                   fric=jnp.zeros((N, C, 5), dtype),
                   trust=jnp.zeros((N + 1, 8), dtype),
                   slack=jnp.zeros((N + 1,), dtype))


def _zmap(f, *zs: ZGroups) -> ZGroups:
    return ZGroups(*(f(*parts) for parts in zip(*zs)))


def _zmax(z: ZGroups) -> jnp.ndarray:
    out = jnp.abs(z.init).max()
    for part in z[1:]:
        out = jnp.maximum(out, jnp.abs(part).max())
    return out


class WVars(NamedTuple):
    """Variable-space vector: states, controls, trust slacks."""

    x: jnp.ndarray   # (N+1, nx)
    u: jnp.ndarray   # (N, nu)
    t: jnp.ndarray   # (N+1,)


def _wmap(f, *ws: WVars) -> WVars:
    return WVars(*(f(*parts) for parts in zip(*ws)))


def _wmax(w: WVars) -> jnp.ndarray:
    return jnp.maximum(jnp.abs(w.x).max(),
                       jnp.maximum(jnp.abs(w.u).max(), jnp.abs(w.t).max()))


class _Scaled(NamedTuple):
    """Ruiz-scaled problem blocks.  Hatted quantities absorb both the row
    scaling E (per constraint) and column scaling D (per variable)."""

    Px: jnp.ndarray       # (N+1, nx, nx) scaled state cost (includes c)
    Pu: jnp.ndarray       # (N, nu, nu)
    q: WVars              # scaled linear cost
    d0: jnp.ndarray       # (nx,) init-row diagonal
    Ah: jnp.ndarray       # (N, nx, nx)
    Bh: jnp.ndarray       # (N, nx, nu)
    Ih: jnp.ndarray       # (N, nx) diagonal coefficient of x_{k+1}
    dN: jnp.ndarray       # (nx,) final-row diagonal
    Gh: jnp.ndarray       # (N, C, 5, nuc)
    coph: jnp.ndarray     # (N, C, 2) scaled CoP row coefficients
    Th: jnp.ndarray       # (N+1, 8, 3) trust rows on angular momentum
    wh: jnp.ndarray       # (N+1, 8) trust-row slack coefficient (positive)
    sh: jnp.ndarray       # (N+1,) slack-row coefficient (positive)
    l: ZGroups
    u: ZGroups
    D: WVars              # variable scaling
    E: ZGroups            # row scaling
    c: jnp.ndarray        # cost scaling


def _apply_A(s: _Scaled, w: WVars) -> ZGroups:
    x, u, t = w
    C, nuc = s.Gh.shape[1], s.Gh.shape[3]
    n = s.Ah.shape[0]
    u_c = u.reshape(n, C, nuc)
    return ZGroups(
        init=s.d0 * x[0],
        dyn=(jnp.einsum("kij,kj->ki", s.Ah, x[:-1])
             + jnp.einsum("kij,kj->ki", s.Bh, u) - s.Ih * x[1:]),
        final=s.dN * x[-1],
        cop=s.coph * u_c[:, :, :2],
        fric=jnp.einsum("kcrj,kcj->kcr", s.Gh, u_c),
        trust=(jnp.einsum("kpj,kj->kp", s.Th, x[:, 6:9])
               - s.wh * t[:, None]),
        slack=-s.sh * t,
    )


def _apply_AT(s: _Scaled, z: ZGroups) -> WVars:
    n, C = s.Ah.shape[0], s.Gh.shape[1]
    x = jnp.zeros((n + 1, s.Ah.shape[1]), z.dyn.dtype)
    x = x.at[0].add(s.d0 * z.init)
    x = x.at[:-1].add(jnp.einsum("kij,ki->kj", s.Ah, z.dyn))
    x = x.at[1:].add(-s.Ih * z.dyn)
    x = x.at[-1].add(s.dN * z.final)
    x = x.at[:, 6:9].add(jnp.einsum("kpj,kp->kj", s.Th, z.trust))
    u = jnp.einsum("kij,ki->kj", s.Bh, z.dyn)
    nuc = s.Gh.shape[3]
    u_c = (jnp.einsum("kcrj,kcr->kcj", s.Gh, z.fric)
           .at[:, :, :2].add(s.coph * z.cop))
    u = u + u_c.reshape(n, C * nuc)
    t = -(s.wh * z.trust).sum(-1) - s.sh * z.slack
    return WVars(x=x, u=u, t=t)


def _row_norms(s: _Scaled) -> ZGroups:
    return ZGroups(
        init=jnp.abs(s.d0),
        dyn=jnp.maximum(jnp.abs(s.Ah).max(-1),
                        jnp.maximum(jnp.abs(s.Bh).max(-1), jnp.abs(s.Ih))),
        final=jnp.abs(s.dN),
        cop=jnp.abs(s.coph),
        fric=jnp.abs(s.Gh).max(-1),
        trust=jnp.maximum(jnp.abs(s.Th).max(-1), s.wh),
        slack=s.sh,
    )


def _col_norms(s: _Scaled) -> WVars:
    """Per-variable inf-norm over the stacked [P; A] columns."""
    n, nx = s.Ah.shape[0], s.Ah.shape[1]
    cx = jnp.abs(s.Px).max(1)                                  # (N+1, nx)
    cx = cx.at[:-1].max(jnp.abs(s.Ah).max(1))
    cx = cx.at[1:].max(jnp.abs(s.Ih))
    cx = cx.at[0].max(jnp.abs(s.d0))
    cx = cx.at[-1].max(jnp.abs(s.dN))
    cx = cx.at[:, 6:9].max(jnp.abs(s.Th).max(1))
    C, nuc = s.Gh.shape[1], s.Gh.shape[3]
    cu_c = jnp.abs(s.Gh).max(2)                               # (N, C, nuc)
    cu_c = cu_c.at[:, :, :2].max(jnp.abs(s.coph))
    cu = jnp.abs(s.Pu).max(1)
    cu = jnp.maximum(cu, cu_c.reshape(n, C * nuc))
    cu = jnp.maximum(cu, jnp.abs(s.Bh).max(1))
    ct = jnp.maximum(s.wh.max(-1), s.sh)
    return WVars(x=cx, u=cu, t=ct)


def _ruiz(qp: BlockQP, iters: int) -> _Scaled:
    N, nx, nu = qp.horizon, qp.A.shape[1], qp.n_u
    dtype = qp.A.dtype
    eps = jnp.asarray(DYN_SLACK, dtype)
    s = _Scaled(
        Px=jnp.broadcast_to(qp.Wx, (N + 1, nx, nx)),
        Pu=jnp.broadcast_to(qp.Wu, (N, nu, nu)),
        q=WVars(x=qp.qx, u=jnp.zeros((N, nu), dtype), t=qp.qt),
        d0=jnp.ones(nx, dtype),
        Ah=qp.A, Bh=qp.B, Ih=jnp.ones((N, nx), dtype),
        dN=jnp.ones(nx, dtype),
        Gh=qp.G,
        coph=qp.cop_act,
        Th=jnp.broadcast_to(qp.penum, (N + 1, 8, 3)),
        wh=jnp.broadcast_to(qp.inv_omega, (N + 1, 8)).astype(dtype),
        sh=jnp.ones(N + 1, dtype),
        l=ZGroups(init=qp.x_init, dyn=qp.r_dyn - eps, final=qp.final_l,
                  cop=qp.cop_l,
                  fric=jnp.full_like(qp.fric_ub, -INF),
                  trust=jnp.full_like(qp.trust_ub, -INF),
                  slack=jnp.full(N + 1, -INF, dtype)),
        u=ZGroups(init=qp.x_init, dyn=qp.r_dyn + eps, final=qp.final_u,
                  cop=qp.cop_u,
                  fric=qp.fric_ub, trust=qp.trust_ub,
                  slack=jnp.zeros(N + 1, dtype)),
        D=WVars(x=jnp.ones((N + 1, nx), dtype),
                u=jnp.ones((N, nu), dtype), t=jnp.ones(N + 1, dtype)),
        E=ZGroups(init=jnp.ones(nx, dtype), dyn=jnp.ones((N, nx), dtype),
                  final=jnp.ones(nx, dtype),
                  cop=jnp.ones_like(qp.cop_act),
                  fric=jnp.ones_like(qp.fric_ub),
                  trust=jnp.ones_like(qp.trust_ub),
                  slack=jnp.ones(N + 1, dtype)),
        c=jnp.ones((), dtype),
    )

    def rescale(s: _Scaled, d: WVars, e: ZGroups, gamma) -> _Scaled:
        C, nuc = s.Gh.shape[1], s.Gh.shape[3]
        n = s.Ah.shape[0]
        du_f = d.u.reshape(n, C, nuc)
        return s._replace(
            Px=s.Px * d.x[:, :, None] * d.x[:, None, :] * gamma,
            Pu=s.Pu * d.u[:, :, None] * d.u[:, None, :] * gamma,
            q=WVars(x=s.q.x * d.x * gamma, u=s.q.u * d.u * gamma,
                    t=s.q.t * d.t * gamma),
            d0=s.d0 * e.init * d.x[0],
            Ah=s.Ah * e.dyn[:, :, None] * d.x[:-1, None, :],
            Bh=s.Bh * e.dyn[:, :, None] * d.u[:, None, :],
            Ih=s.Ih * e.dyn * d.x[1:],
            dN=s.dN * e.final * d.x[-1],
            Gh=s.Gh * e.fric[..., None] * du_f[:, :, None, :],
            coph=s.coph * e.cop * du_f[:, :, :2],
            Th=s.Th * e.trust[..., None] * d.x[:, None, 6:9],
            wh=s.wh * e.trust * d.t[:, None],
            sh=s.sh * e.slack * d.t,
            l=_zmap(lambda a, b: a * b, s.l, e),
            u=_zmap(lambda a, b: a * b, s.u, e),
            D=_wmap(lambda a, b: a * b, s.D, d),
            E=_zmap(lambda a, b: a * b, s.E, e),
            c=s.c * gamma,
        )

    def body(_, s: _Scaled) -> _Scaled:
        # Column and row norms are both taken from the SAME current scaled
        # problem, then applied together -- matching ops.admm (and OSQP's)
        # iteration so both paths reach the same equilibrium and therefore
        # the same relative termination thresholds.
        cn = _col_norms(s)
        d = _wmap(lambda a: 1.0 / jnp.sqrt(jnp.where(a > 0, a, 1.0)), cn)
        rn = _row_norms(s)
        e = _zmap(lambda a: 1.0 / jnp.sqrt(jnp.where(a > 0, a, 1.0)), rn)
        s = rescale(s, d, e, 1.0)
        # cost normalization: gamma = 1/max(mean |P| col norm, |q|_inf).
        # The mean runs over the full dense variable count (including the
        # all-zero slack columns) so the cost scale c -- and with it the
        # relative dual tolerance -- matches ops.admm exactly.
        n_dense = (nx * (N + 1) + nu * N) + (N + 1) + N
        p_sum = jnp.abs(s.Px).max(1).sum() + jnp.abs(s.Pu).max(1).sum()
        gamma_den = jnp.maximum(p_sum / n_dense, _wmax(s.q))
        gamma = 1.0 / jnp.where(gamma_den > 0, gamma_den, 1.0)
        return s._replace(Px=s.Px * gamma, Pu=s.Pu * gamma,
                          q=_wmap(lambda a: a * gamma, s.q), c=s.c * gamma)

    return jax.lax.fori_loop(0, iters, body, s, unroll=True)


def _rho_groups(settings: QPSettings, rho, s: _Scaled) -> ZGroups:
    """Per-row ADMM step sizes, full group shapes (equality rows get
    eq_rho_scale * rho).  Full arrays (not broadcast scalars) so the
    polish path can reuse the same assembly with its masked penalties."""
    N, nx = s.Ah.shape[0], s.Ah.shape[1]
    C = s.Gh.shape[1]
    dtype = s.Ah.dtype
    rho = jnp.asarray(rho, dtype)
    req = settings.eq_rho_scale * rho
    return ZGroups(
        init=jnp.full((nx,), req, dtype),
        dyn=jnp.full((N, nx), req, dtype),
        final=jnp.full((nx,), req, dtype),
        cop=jnp.full((N, C, 2), rho, dtype),
        fric=jnp.full((N, C, 5), rho, dtype),
        trust=jnp.full((N + 1, 8), rho, dtype),
        slack=jnp.full((N + 1,), rho, dtype))


def _assemble_blocks(s: _Scaled, r: ZGroups, sigma):
    """Block-tridiagonal M = P + sigma I + A' diag(rho) A for per-row
    step sizes r (ZGroups of full row-group shape).

    Returns (diag (N+1, V, V), off (N, V, V)) with per-knot variable
    ordering [x (nx), u (nu), t (1)]; the control slot of knot N is a
    padded dummy with unit diagonal.
    """
    N, nx, nu = s.Ah.shape[0], s.Ah.shape[1], s.Bh.shape[2]
    V = nx + nu + 1
    dtype = s.Ah.dtype
    C = s.Gh.shape[1]
    eye_nx = jnp.eye(nx, dtype=dtype)

    # All updates below are static-slice adds or eye-masked broadcasts --
    # advanced-index scatters lower to real scatter ops, which cost ~17%
    # of the whole batched solve (profile_blockqp2).
    diag = jnp.zeros((N + 1, V, V), dtype)
    diag = diag + sigma * jnp.eye(V, dtype=dtype)
    # state cost
    diag = diag.at[:, :nx, :nx].add(s.Px)
    # control cost (knots < N); dummy identity on knot N's control slot
    diag = diag.at[:-1, nx:nx + nu, nx:nx + nu].add(s.Pu)
    diag = diag.at[-1, nx:nx + nu, nx:nx + nu].add(jnp.eye(nu, dtype=dtype))
    # init / final rows (diagonal embeddings)
    diag = diag.at[0, :nx, :nx].add((r.init * s.d0**2)[:, None] * eye_nx)
    diag = diag.at[-1, :nx, :nx].add((r.final * s.dN**2)[:, None] * eye_nx)
    # dynamics rows k: (A B) ' rho (A B) on knot k, I'rho I on knot k+1
    diag = diag.at[:-1, :nx, :nx].add(
        jnp.einsum("ki,kij,kil->kjl", r.dyn, s.Ah, s.Ah))
    rAB = jnp.einsum("ki,kij,kil->kjl", r.dyn, s.Ah, s.Bh)
    diag = diag.at[:-1, :nx, nx:nx + nu].add(rAB)
    diag = diag.at[:-1, nx:nx + nu, :nx].add(rAB.swapaxes(1, 2))
    diag = diag.at[:-1, nx:nx + nu, nx:nx + nu].add(
        jnp.einsum("ki,kij,kil->kjl", r.dyn, s.Bh, s.Bh))
    diag = diag.at[1:, :nx, :nx].add(
        (r.dyn * s.Ih**2)[:, :, None] * eye_nx[None])
    # friction + CoP rows: per-contact nuc x nuc blocks, embedded as a
    # block-diagonal (N, nu, nu) via a contact-identity mask
    nuc = s.Gh.shape[3]
    gtg = jnp.einsum("kcr,kcrj,kcrl->kcjl", r.fric, s.Gh, s.Gh)
    cop_sq = r.cop * s.coph**2                                 # (N, C, 2)
    cop_full = jnp.zeros((N, C, nuc), dtype).at[:, :, :2].set(cop_sq)
    gtg = gtg + cop_full[..., None] * jnp.eye(nuc, dtype=dtype)  # on [d,d]
    blk = (gtg[:, :, :, None, :]
           * jnp.eye(C, dtype=dtype)[None, :, None, :, None])
    diag = diag.at[:-1, nx:nx + nu, nx:nx + nu].add(
        blk.reshape(N, nu, nu))
    # trust rows: on (ang, t)
    diag = diag.at[:, 6:9, 6:9].add(
        jnp.einsum("kp,kpj,kpl->kjl", r.trust, s.Th, s.Th))
    cross = -jnp.einsum("kp,kpj,kp->kj", r.trust, s.Th, s.wh)  # (N+1, 3)
    diag = diag.at[:, 6:9, V - 1].add(cross)
    diag = diag.at[:, V - 1, 6:9].add(cross)
    diag = diag.at[:, V - 1, V - 1].add(
        (r.trust * s.wh**2).sum(-1) + r.slack * s.sh**2)

    off = jnp.zeros((N, V, V), dtype)
    # rows of knot k+1 (x part) coupling to knot k's (x, u)
    off = off.at[:, :nx, :nx].set(-(r.dyn * s.Ih)[:, :, None] * s.Ah)
    off = off.at[:, :nx, nx:nx + nu].set(-(r.dyn * s.Ih)[:, :, None] * s.Bh)
    return diag, off


class _TridiagFactor(NamedTuple):
    """Inverted blocked Cholesky factor of the block-tridiagonal M.

    Stored pre-inverted so the per-ADMM-iteration sweeps are pure matvec
    recurrences (no triangular_solve inside the hot loop, and the sweeps
    can run as one fused kernel, ops/sweep_kernel.py).  With L_kk = C_k,
    L_{k+1,k} = W_k:
      Cinv:  C_k^{-1}               (N+1, V, V)
      CinvT: C_k^{-T}               (N+1, V, V)
      Pfwd:  C_k^{-1} W_{k-1}       (N, V, V)   forward coupling
      Pbwd:  C_k^{-T} W_k'          (N, V, V)   backward coupling
    """

    Cinv: jnp.ndarray
    CinvT: jnp.ndarray
    Pfwd: jnp.ndarray
    Pbwd: jnp.ndarray


def _block_tridiag_cholesky(diag, off) -> _TridiagFactor:
    """Blocked Cholesky M = L L' (sequential over knots, once per solve)."""

    def step(carry, inputs):
        prev_c = carry
        d_k, o_prev = inputs
        w = jax.scipy.linalg.solve_triangular(
            prev_c, o_prev.T, lower=True).T            # W = O C^{-T}
        c = jnp.linalg.cholesky(d_k - w @ w.T)
        return c, (c, w)

    c0 = jnp.linalg.cholesky(diag[0])
    _, (cs, ws) = jax.lax.scan(step, c0, (diag[1:], off))
    chol_c = jnp.concatenate([c0[None], cs], axis=0)
    # Invert all factors at once (parallel over knots).
    eye = jnp.broadcast_to(jnp.eye(diag.shape[1], dtype=diag.dtype),
                           chol_c.shape)
    cinv = jax.scipy.linalg.solve_triangular(chol_c, eye, lower=True)
    cinv_t = cinv.swapaxes(-1, -2)
    p_fwd = jnp.einsum("kij,kjl->kil", cinv[1:], ws)
    p_bwd = jnp.einsum("kij,klj->kil", cinv_t[:-1], ws)
    return _TridiagFactor(Cinv=cinv, CinvT=cinv_t, Pfwd=p_fwd, Pbwd=p_bwd)


class _ThomasFactor(NamedTuple):
    """Block-Thomas factorization with explicit Schur-complement inverses.

    T_k = S_k^{-1} with S_0 = D_0, S_k = D_k - O_{k-1} T_{k-1} O_{k-1}';
    G_k = O_{k-1} T_{k-1} (forward coupling), H_k = T_k O_k' (backward).
    The inverses come from the matmul-only Newton-Schulz iteration
    (ops/linalg.spd_inverse) so the whole factorization lowers to batched
    matmuls -- no per-step Cholesky/triangular ops.
    """

    T: jnp.ndarray    # (N+1, V, V)
    G: jnp.ndarray    # (N, V, V)
    H: jnp.ndarray    # (N, V, V)


def _block_tridiag_thomas(diag, off) -> _ThomasFactor:
    from centroidal_mpc_tpu.ops.linalg import spd_inverse

    def step(t_prev, inputs):
        d_k, o_prev = inputs
        s_k = d_k - o_prev @ t_prev @ o_prev.T
        t_k = spd_inverse(s_k)
        return t_k, t_k

    t0 = spd_inverse(diag[0])
    _, ts = jax.lax.scan(step, t0, (diag[1:], off))
    T = jnp.concatenate([t0[None], ts], axis=0)
    G = jnp.einsum("kij,kjl->kil", off, T[:-1])
    H = jnp.einsum("kij,klj->kil", T[:-1], off)
    return _ThomasFactor(T=T, G=G, H=H)


def _block_thomas_solve(f: _ThomasFactor, b):
    """Solve M w = b with the Thomas factor: forward elimination, one
    knot-parallel application of T, backward substitution."""

    def fwd(y_prev, inputs):
        b_k, g_k = inputs
        y = b_k - g_k @ y_prev
        return y, y

    _, ys = jax.lax.scan(fwd, b[0], (b[1:], f.G))
    y = jnp.concatenate([b[:1], ys], axis=0)
    t = jnp.einsum("kij,kj->ki", f.T, y)

    def bwd(w_next, inputs):
        t_k, h_k = inputs
        w = t_k - h_k @ w_next
        return w, w

    _, ws = jax.lax.scan(bwd, t[-1], (t[:-1], f.H), reverse=True)
    return jnp.concatenate([ws, t[-1:]], axis=0)


def _affine_sweep_assoc(P, c, reverse: bool):
    """All-prefix solution of v_k = c_k - P_k v_{k +- 1} by associative
    scan: elements (A_k, b_k) with combine (A2,b2)o(A1,b1) =
    (A2 A1, A2 b1 + b2); the boundary element carries A = 0 so prefixes
    forget the seed.  Depth log2(N) instead of N sequential steps -- the
    latency-mode sweep (more FLOPs, far fewer dependent steps).
    P: (N, V, V); c: (N+1, V) -> (N+1, V)."""
    V = c.shape[-1]
    zero = jnp.zeros((1, V, V), P.dtype)
    A = (jnp.concatenate([-P, zero], axis=0) if reverse
         else jnp.concatenate([zero, -P], axis=0))

    def combine(x, y):
        ax, bx = x
        ay, by = y
        return ay @ ax, jnp.einsum("...ij,...j->...i", ay, bx) + by

    _, out = jax.lax.associative_scan(combine, (A, c), reverse=reverse,
                                      axis=0)
    return out


def _block_tridiag_solve(f: _TridiagFactor, b, sweep_method: str = "scan"):
    """Solve M w = b; b, w shaped (N+1, V).  Two matvec-only sweeps plus
    two knot-parallel einsums.  'scan' (throughput default) runs the
    sweeps sequentially (`_sequential_sweeps`); 'assoc' (latency mode)
    as log-depth associative scans."""
    if sweep_method != "assoc":
        return _sequential_sweeps(f, b)
    c = jnp.einsum("kij,kj->ki", f.Cinv, b)            # C_k^{-1} b_k
    v = _affine_sweep_assoc(f.Pfwd, c, reverse=False)
    d = jnp.einsum("kij,kj->ki", f.CinvT, v)           # C_k^{-T} v_k
    return _affine_sweep_assoc(f.Pbwd, d, reverse=True)


def _kernel_sweeps(f: _TridiagFactor, b):
    return block_tridiag_sweep(f.Cinv, f.CinvT, f.Pfwd, f.Pbwd, b)


def _sequential_sweeps(f: _TridiagFactor, b):
    """The sequential backsolve.  Lowered for a GPU, f32 runs the fused
    kernel (ops/sweep_kernel.py: one launch per backsolve; faster than
    the XLA scans at every shape measured on an H100, PERF.md); every
    other platform and dtype runs the two XLA scans."""
    if b.dtype != jnp.float32:
        return _scan_sweeps(f, b)
    return jax.lax.platform_dependent(f, b, cuda=_kernel_sweeps,
                                      default=_scan_sweeps)


def _scan_sweeps(f: _TridiagFactor, b):
    """The sequential backsolve as two XLA `lax.scan`s over the knots."""
    c = jnp.einsum("kij,kj->ki", f.Cinv, b)            # C_k^{-1} b_k

    def fwd(v_prev, inputs):
        c_k, p_k = inputs
        v = c_k - p_k @ v_prev
        return v, v

    _, vs = jax.lax.scan(fwd, c[0], (c[1:], f.Pfwd))
    v = jnp.concatenate([c[:1], vs], axis=0)

    d = jnp.einsum("kij,kj->ki", f.CinvT, v)           # C_k^{-T} v_k

    def bwd(w_next, inputs):
        d_k, p_k = inputs
        w = d_k - p_k @ w_next
        return w, w

    _, wss = jax.lax.scan(bwd, d[-1], (d[:-1], f.Pbwd), reverse=True)
    return jnp.concatenate([wss, d[-1:]], axis=0)


def _pack(w: WVars, nx, nu) -> jnp.ndarray:
    n = w.u.shape[0]
    W = jnp.zeros((n + 1, nx + nu + 1), w.x.dtype)
    W = W.at[:, :nx].set(w.x)
    W = W.at[:-1, nx:nx + nu].set(w.u)
    W = W.at[:, -1].set(w.t)
    return W


def _unpack(W: jnp.ndarray, nx, nu) -> WVars:
    return WVars(x=W[:, :nx], u=W[:-1, nx:nx + nu], t=W[:, -1])


def _certificates(s: _Scaled, settings: QPSettings, dw: WVars,
                  dy: ZGroups):
    """OSQP primal/dual infeasibility certificate tests (Stellato et al.
    sec. 3.4) on the iterate deltas of one residual-check segment.

    Candidate primal-infeasibility certificate ybar = E dy, candidate
    dual-infeasibility certificate xbar = D dw (positive scalars like 1/c
    dropped -- certificates are rays); both are tested against the
    UNSCALED problem data, consistent with _residuals.  The reference
    relies on OSQP's version of these tests and aborts the SCP loop on
    an infeasible status (src/scp_solver.py:59-68); without them an
    infeasible QP burns the whole iteration budget before being reported
    as mere non-convergence (VERDICT round 3, missing item 2).
    """
    dtype = s.sh.dtype
    # ---- primal infeasibility via dy:  A'ybar ~ 0  and
    #      u'[ybar]+ + l'[ybar]- < 0 ----
    y_norm = _zmax(_zmap(lambda a, e: a * e, dy, s.E))
    atdy = _wmax(_wmap(lambda a, d: a / d, _apply_AT(s, dy), s.D))
    eps_p = settings.eps_pinf * y_norm
    # support function over FINITE bounds only (scaled identity:
    # uhat'[dy]+ + lhat'[dy]-); infinite-bound rows instead require the
    # recession-feasible sign of dy to within eps (OSQP's convention --
    # multiplying the INF sentinel in would let 1e-15 sign noise on a
    # one-sided row poison the sum)
    sup = jnp.zeros((), dtype)
    sign_ok = jnp.asarray(True)
    for lo, hi, d, e in zip(s.l, s.u, dy, s.E):
        fin_u = (hi / e) < 0.5 * INF
        fin_l = (lo / e) > -0.5 * INF
        sup = sup + jnp.sum(
            jnp.where(fin_u, hi * jnp.maximum(d, 0.0), 0.0)
            + jnp.where(fin_l, lo * jnp.minimum(d, 0.0), 0.0))
        sign_ok = sign_ok & jnp.all(fin_u | (e * d <= eps_p))
        sign_ok = sign_ok & jnp.all(fin_l | (e * d >= -eps_p))
    pinf = (y_norm > 0) & (atdy <= eps_p) & sign_ok & (sup <= -eps_p)

    # ---- dual infeasibility via dw:  P xbar ~ 0, q'xbar < 0, and
    #      A xbar inside the recession cone of [l, u] ----
    x_norm = _wmax(_wmap(lambda a, d: a * d, dw, s.D))
    Pdw = WVars(x=jnp.einsum("kij,kj->ki", s.Px, dw.x),
                u=jnp.einsum("kij,kj->ki", s.Pu, dw.u),
                t=jnp.zeros_like(dw.t))
    pdx = _wmax(_wmap(lambda a, d: a / d, Pdw, s.D)) / s.c
    qdx = sum(jnp.sum(qq * dd) for qq, dd in zip(s.q, dw)) / s.c
    Adw = _apply_A(s, dw)
    eps_d = settings.eps_dinf * x_norm
    cone_ok = jnp.asarray(True)
    for lo, hi, a, e in zip(s.l, s.u, Adw, s.E):
        a_un = a / e
        fin_u = (hi / e) < 0.5 * INF
        fin_l = (lo / e) > -0.5 * INF
        cone_ok = cone_ok & jnp.all(~fin_u | (a_un <= eps_d))
        cone_ok = cone_ok & jnp.all(~fin_l | (a_un >= -eps_d))
    dinf = ((x_norm > 0) & (pdx <= eps_d) & (qdx <= -eps_d) & cone_ok)
    return pinf, dinf


def _two_sum(hi: ZGroups, lo: ZGroups, d: ZGroups):
    """Accumulate a correction d into the two-float dual (hi, lo):
    hi' = fl(hi + d) with the exact rounding error folded into lo
    (Knuth TwoSum, branch-free, no FMA needed).  The scaled equality
    duals sit at O(1e2) while the eps=1e-5 dual residual must be
    resolved at O(1e-5) -- one f32 ulp of y (~5e-6) moves A'y by the
    entire residual magnitude, so a single-f32 dual cannot CARRY a
    certified tight solution between refinement phases.  Storing y as
    an unevaluated hi+lo pair (and applying A' to both parts) keeps
    ~48 bits of the dual at pure-f32 cost."""
    def one(h, l, dd):
        s_ = h + dd
        bb = s_ - h
        err = (h - (s_ - bb)) + (dd - bb)
        return s_, l + err
    out = [one(h, l, dd) for h, l, dd in zip(hi, lo, d)]
    return (ZGroups(*(o[0] for o in out)), ZGroups(*(o[1] for o in out)))


def _residuals(s: _Scaled, settings: QPSettings, w: WVars, z: ZGroups,
               y: ZGroups, y_lo: ZGroups | None = None):
    """Unscaled OSQP termination residuals and their relative scales.

    y_lo: optional low part of a two-float dual (see _two_sum); the
    dual residual is then evaluated as P w + q + A'y + A'y_lo, which
    resolves it below the one-ulp-of-y noise floor of a collapsed f32
    dual."""
    Aw = _apply_A(s, w)
    Pw = WVars(x=jnp.einsum("kij,kj->ki", s.Px, w.x),
               u=jnp.einsum("kij,kj->ki", s.Pu, w.u),
               t=jnp.zeros_like(w.t))
    ATy = _apply_AT(s, y)
    if y_lo is not None:
        ATy = _wmap(lambda a, b: a + b, ATy, _apply_AT(s, y_lo))
    prim = _zmax(_zmap(lambda a, b, e: (a - b) / e, Aw, z, s.E))
    dual = _wmax(_wmap(lambda p, q, at, d: (p + q + at) / d,
                       Pw, s.q, ATy, s.D)) / s.c
    prim_scale = jnp.maximum(
        _zmax(_zmap(lambda a, e: a / e, Aw, s.E)),
        _zmax(_zmap(lambda a, e: a / e, z, s.E)))
    dual_scale = jnp.maximum(
        jnp.maximum(_wmax(_wmap(lambda a, d: a / d, Pw, s.D)),
                    _wmax(_wmap(lambda a, d: a / d, ATy, s.D))),
        _wmax(_wmap(lambda a, d: a / d, s.q, s.D))) / s.c
    eps_prim = settings.eps_abs + settings.eps_rel * prim_scale
    eps_dual = settings.eps_abs + settings.eps_rel * dual_scale
    return prim, dual, eps_prim, eps_dual, prim_scale, dual_scale


def _polish(s: _Scaled, settings: QPSettings, sigma, factorize, backsolve,
            w: WVars, y: ZGroups, nx: int, nu: int):
    """OSQP-style solution polish as augmented-Lagrangian iterative
    refinement.

    The reference runs OSQP with polish=on (src/scp_solver.py:62): after
    ADMM terminates, OSQP solves the KKT system of the *active* rows to
    machine precision.  A dynamic reduced KKT does not fit XLA's static
    shapes, so the same effect comes from a masked ALM: active rows keep
    a large penalty (polish_rho) while inactive rows drop out (rho = 0),
    one extra block-tridiagonal factorization per round + polish_iters
    multiplier updates.

    Numerical structure (the SURVEY section-7c "mixed-precision
    refinement" hard part, done the f32-native way): each sweep solves
    for the CORRECTION  M dw = r_dual + A' rho r_primal,  w += dw,
    rather than for w directly from the large sigma*w + A'(rho b - y)
    right-hand side.  Algebraically identical fixed point (exact
    active-row KKT), but in f32 the direct form carries roundoff
    proportional to the big operands while the residual form's error is
    proportional to the residuals -- which the iteration drives toward
    zero.  This IS iterative refinement against the factorized M.  The
    factorization uses its own proximal regularization polish_sigma
    (>> sigma) so cond(M) * eps_f32 stays below 1 and the refinement
    contracts; polish_sigma does not move the fixed point because the
    residual form never adds a sigma*(w - w_prev) term.

    polish_rounds > 1 re-detects the active set from the polished
    iterate and repeats -- at loose main-loop eps the first detection
    can mislabel weakly-active rows.  Returns (w, z, y, y_lo) where
    (y, y_lo) is the TWO-FLOAT dual refined by the CG stage (see
    _two_sum); the caller evaluates residuals with y_lo and keeps
    whichever of (ADMM, polished) is better, matching OSQP's
    accept-if-improves semantics.  Fixed shapes and no conds: safe
    under vmap/shard_map.
    """
    pack = lambda ww: _pack(ww, nx, nu)
    unpack = lambda W: _unpack(W, nx, nu)
    zdot = lambda a, b: sum(jnp.sum(x * yv) for x, yv in zip(a, b))
    zscale = lambda c_, z_: type(z_)(*(c_ * v for v in z_))
    atol = settings.polish_active_tol
    ytol = 1e-12
    dtype = s.sh.dtype

    def applyP(w_):
        return WVars(x=jnp.einsum("...kij,...kj->...ki", s.Px, w_.x),
                     u=jnp.einsum("...kij,...kj->...ki", s.Pu, w_.u),
                     t=jnp.zeros_like(w_.t))

    def detect(z, y):
        masks, targets = [], []
        for lo, hi, zz, yy, ee in zip(s.l, s.u, z, y, s.E):
            # finiteness judged on unscaled bounds (lo/ee, hi/ee): row
            # scaling moves the 1e20 sentinel by O(1) factors
            low = ((((zz - lo) < atol) | (yy < -ytol))
                   & (lo / ee > -0.5 * INF))
            high = ((((hi - zz) < atol) | (yy > ytol))
                    & (hi / ee < 0.5 * INF))
            m = low | high
            masks.append(m)
            targets.append(jnp.where(m, jnp.where(high, hi, lo), 0.0))
        return ZGroups(*masks), ZGroups(*targets)

    w_p, y_p = w, y
    Aw = _apply_A(s, w_p)   # maintained as A w_p across rounds/iterations
    # at least one round: the CG block below needs a detected active
    # set and its factorization
    for rnd in range(max(settings.polish_rounds, 1)):
        # rho/sigma ramp: later rounds raise the penalty (faster
        # multiplier contraction on near-degenerate active-row
        # directions) while cond(M) ~ rho/sigma stays f32-safe
        ramp = settings.polish_rho_ramp ** rnd
        beta = jnp.asarray(settings.polish_rho * ramp, dtype)
        dsig = jnp.asarray(settings.polish_sigma * ramp, dtype) - sigma
        mask, b_a = detect(Aw, y_p)
        rho_p = ZGroups(*(m.astype(dtype) * beta for m in mask))
        diag, off = _assemble_blocks(s, rho_p, sigma)
        # lift the proximal regularization to polish_sigma (identity
        # shift)
        eye = jnp.eye(diag.shape[-1], dtype=dtype)
        fac_p = factorize(diag + dsig * eye, off)

        y_p = ZGroups(*(jnp.where(m, yy, 0.0)
                        for m, yy in zip(mask, y_p)))
        for _ in range(settings.polish_iters):
            r_p = ZGroups(*(rr * (bb - aa) for rr, bb, aa in
                            zip(rho_p, b_a, Aw)))            # rho-scaled
            rpy = ZGroups(*(rp - yy for rp, yy in zip(r_p, y_p)))
            rhs = _wmap(lambda pw, qq, at: -(pw + qq) + at,
                        applyP(w_p), s.q, _apply_AT(s, rpy))
            dw = unpack(backsolve(fac_p, pack(rhs)))
            w_p = _wmap(lambda a, b: a + b, w_p, dw)
            Aw = _apply_A(s, w_p)
            y_p = ZGroups(*(yy + rr * (aa - bb) for yy, rr, aa, bb in
                            zip(y_p, rho_p, Aw, b_a)))

    # two-float dual from here on: the CG/CGLS corrections accumulate
    # into (y_p, y_lo) via TwoSum and every gradient/residual evaluates
    # A'y_p + A'y_lo (see _two_sum for why a single f32 dual cannot
    # carry an eps=1e-5-certified solution)
    y_lo = ZGroups(*(jnp.zeros_like(v) for v in y_p))

    if settings.polish_cg_iters > 0:
        # Dual refinement: CG on the ALM-preconditioned normal
        # equations S dy = -A M^-1 g with S = A_act M^-1 A_act'.  The
        # ALM multiplier update above is Richardson iteration on the
        # same system -- its slow modes (near-degenerate active-row
        # directions) leave the dual residual O(1) long after the
        # primal is exact; CG converges them in ~15 iterations
        # (measured: dual 1.9 -> 0.03 on the N=50 trot QP; the primal
        # is untouched since only y moves).  Restart phases recompute
        # the TRUE residual from the updated y -- evaluated against the
        # TWO-FLOAT dual (y_p, y_lo), which is what lets restarts
        # actually compound: with a single-f32 y the accepted dy is
        # rounded away (one ulp of the O(1e2) equality duals is the
        # size of the whole eps=1e-5 residual) and the measured dual
        # floors at ~2-3e-2 regardless of iterations -- the round-4
        # "f32 dual floor", which an f64-island experiment (round 5)
        # proved was storage/measurement precision, not the Krylov
        # solver: the dual least-squares optimum over the same active
        # rows sits at ~1e-7 (benchmarks/_probe_lsq.py).
        maskf = ZGroups(*(m.astype(dtype) for m in mask))

        def S_op(v):
            vm = ZGroups(*(mf * vv for mf, vv in zip(maskf, v)))
            out = _apply_A(s, unpack(backsolve(
                fac_p, pack(_apply_AT(s, vm)))))
            return ZGroups(*(mf * oo for mf, oo in zip(maskf, out)))

        for _ in range(max(settings.polish_cg_restarts, 1)):
            g = _wmap(lambda pw, qq, at, atl: pw + qq + at + atl,
                      applyP(w_p), s.q, _apply_AT(s, y_p),
                      _apply_AT(s, y_lo))
            rhs_cg = _apply_A(s, unpack(backsolve(fac_p, pack(g))))
            r = ZGroups(*(-(mf * rr) for mf, rr in zip(maskf, rhs_cg)))
            dy = ZGroups(*(jnp.zeros_like(v) for v in r))
            p = r
            rr_old = zdot(r, r)
            for _ in range(settings.polish_cg_iters):
                Sp = S_op(p)
                alpha = rr_old / jnp.maximum(zdot(p, Sp), 1e-30)
                dy = ZGroups(*(d + av for d, av in
                               zip(dy, zscale(alpha, p))))
                r = ZGroups(*(rv - av for rv, av in
                              zip(r, zscale(alpha, Sp))))
                rr_new = zdot(r, r)
                beta_cg = rr_new / jnp.maximum(rr_old, 1e-30)
                p = ZGroups(*(rv + bv for rv, bv in
                              zip(r, zscale(beta_cg, p))))
                rr_old = rr_new
            y_p, y_lo = _two_sum(y_p, y_lo, dy)

    # the CG refinement moved only y, so Aw still equals A w_p
    z_p = ZGroups(*(jnp.clip(aa, lo, hi) for aa, lo, hi in
                    zip(Aw, s.l, s.u)))
    return w_p, z_p, y_p, y_lo


class BlockQPSolution(struct.PyTreeNode):
    X: jnp.ndarray
    U: jnp.ndarray
    t: jnp.ndarray
    y: ZGroups
    iterations: jnp.ndarray
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    converged: jnp.ndarray
    status: jnp.ndarray       # int32 STATUS_* (ops.admm)
    stalled: jnp.ndarray      # bool: the ADMM loop left on the stall exit
    polished: jnp.ndarray     # bool: the polished iterate was kept


@highest_precision
def solve_block_qp(qp: BlockQP, settings: QPSettings = QPSettings(),
                   w0: WVars | None = None,
                   y0: ZGroups | None = None) -> BlockQPSolution:
    """Structured ADMM solve; same semantics as ops.admm.solve_qp."""
    N, nx, nu = qp.horizon, qp.A.shape[1], qp.n_u
    dtype = qp.A.dtype
    s = _ruiz(qp, settings.scaling_iters)
    sigma = jnp.asarray(settings.sigma, dtype)
    n_segments = -(-settings.max_iter // settings.check_interval)

    cond_mode = (settings.adaptive_rho
                 and settings.adaptive_rho_mode != "always")

    if settings.factor_method == "thomas":
        factorize, backsolve = _block_tridiag_thomas, _block_thomas_solve
    else:
        factorize = _block_tridiag_cholesky
        backsolve = lambda fac, b: _block_tridiag_solve(
            fac, b, settings.sweep_method)

    def factor(rho):
        rho_g = _rho_groups(settings, rho, s)
        diag, off = _assemble_blocks(s, rho_g, sigma)
        return factorize(diag, off)

    rho0 = jnp.asarray(settings.rho, dtype)
    fac = factor(rho0)
    rho_g = _rho_groups(settings, rho0, s)

    if w0 is None:
        w = WVars(x=jnp.zeros((N + 1, nx), dtype),
                  u=jnp.zeros((N, nu), dtype), t=jnp.zeros(N + 1, dtype))
    else:
        w = _wmap(lambda a, b: a / b, w0, s.D)
    if y0 is None:
        y = _zmap(lambda a: jnp.zeros_like(a), s.l)
    else:
        y = _zmap(lambda a, b: s.c * a / b, y0, s.E)
    z = _apply_A(s, w)

    def admm_iter(_, state):
        w, z, y, rho_g, fac = state
        rz_y = ZGroups(*(rr * zz - yy for zz, yy, rr in zip(z, y, rho_g)))
        rhs = _wmap(lambda ww, at, qq: sigma * ww + at - qq,
                    w, _apply_AT(s, rz_y), s.q)
        w_t = _unpack(backsolve(fac, _pack(rhs, nx, nu)), nx, nu)
        z_t = _apply_A(s, w_t)
        a = settings.alpha
        w_new = _wmap(lambda wt, ww: a * wt + (1 - a) * ww, w_t, w)
        z_rel = _zmap(lambda zt, zz: a * zt + (1 - a) * zz, z_t, z)

        def project(zr, yy, rr, lo, hi):
            return jnp.clip(zr + yy / rr, lo, hi)

        z_new = ZGroups(*(project(zr, yy, rr, lo, hi)
                          for zr, yy, rr, lo, hi in
                          zip(z_rel, y, rho_g, s.l, s.u)))
        y_new = ZGroups(*(yy + rr * (zr - zn) for yy, rr, zr, zn in zip(
            y, rho_g, z_rel, z_new)))
        return w_new, z_new, y_new, rho_g, fac

    def rho_ratio(prim, dual, prim_scale, dual_scale):
        return jnp.sqrt(
            (prim / jnp.maximum(prim_scale, 1e-30))
            / jnp.maximum(dual / jnp.maximum(dual_scale, 1e-30), 1e-30))

    def check_segment(w0, y0, w, z, y):
        """Residuals + convergence/infeasibility statuses for a segment
        that advanced (w0, y0) -> (w, y)."""
        (prim, dual, eps_prim, eps_dual,
         prim_scale, dual_scale) = _residuals(s, settings, w, z, y)
        done = (prim < eps_prim) & (dual < eps_dual)
        status = jnp.where(done, STATUS_SOLVED,
                           STATUS_MAX_ITER).astype(jnp.int32)
        if settings.check_infeasibility:
            dw = _wmap(lambda a, b: a - b, w, w0)
            dy = _zmap(lambda a, b: a - b, y, y0)
            pinf, dinf = _certificates(s, settings, dw, dy)
            status = jnp.where(
                pinf & ~done, STATUS_PRIMAL_INFEASIBLE,
                jnp.where(dinf & ~done, STATUS_DUAL_INFEASIBLE,
                          status)).astype(jnp.int32)
            done = done | ((pinf | dinf) & ~done)
        return prim, dual, done, status, prim_scale, dual_scale

    def update_best(best, w, z, y, prim, dual):
        wb, zb, yb, pb, db, stall = best
        improve = (jnp.maximum(prim, dual)
                   < 0.99 * jnp.maximum(pb, db))
        take = lambda new, old: jnp.where(improve, new, old)
        return (_wmap(take, w, wb), _zmap(take, z, zb),
                _zmap(take, y, yb), jnp.where(improve, prim, pb),
                jnp.where(improve, dual, db),
                jnp.where(improve, 0, stall + 1))

    def stalled(best):
        if settings.stall_segments <= 0:
            return jnp.asarray(False)
        return best[-1] >= settings.stall_segments

    inf0 = jnp.asarray(jnp.inf, dtype)
    best0 = (w, z, y, inf0, inf0, jnp.zeros((), jnp.int32))

    if cond_mode:
        # 'cond' adaptation must carry the factorization across segments
        # (it refactors only when the ratio leaves the deadband).
        def segment(carry):
            w0, z, y0, rho, rho_g, fac, it, _, _, _, _, best = carry
            w, z, y, rho_g, fac = jax.lax.fori_loop(
                0, settings.check_interval, admm_iter,
                (w0, z, y0, rho_g, fac))
            it = it + settings.check_interval

            (prim, dual, done, status,
             prim_scale, dual_scale) = check_segment(w0, y0, w, z, y)

            ratio = rho_ratio(prim, dual, prim_scale, dual_scale)
            new_rho = jnp.clip(rho * ratio, 1e-6, 1e6)
            trigger = ((ratio > settings.adaptive_rho_tol)
                       | (ratio < 1.0 / settings.adaptive_rho_tol)) & ~done

            def refactor(_):
                return (new_rho, _rho_groups(settings, new_rho, s),
                        factor(new_rho))

            rho, rho_g, fac = jax.lax.cond(
                trigger, refactor, lambda _: (rho, rho_g, fac), None)
            best = update_best(best, w, z, y, prim, dual)
            done = done | stalled(best)
            return (w, z, y, rho, rho_g, fac, it, prim, dual, done,
                    status, best)

        def loop_cond(carry):
            _, _, _, _, _, _, it, _, _, done, _, _ = carry
            return (~done) & (it < n_segments * settings.check_interval)

        init = (w, z, y, rho0, rho_g, fac,
                jnp.zeros((), jnp.int32), inf0, inf0,
                jnp.asarray(False), jnp.zeros((), jnp.int32), best0)
        (w, z, y, _, _, _, it, prim, dual, done, status,
         best) = jax.lax.while_loop(loop_cond, segment, init)
    else:
        # Fixed rho, or 'always' adaptation: the factorization is a pure
        # function of the carried rho scalar (or a closure constant), so
        # it stays OUT of the while_loop carry: the batched while_loop
        # then needs no per-scenario select over the factor pytree (same
        # factor count: 'always' refactors once per segment either way).
        def segment(carry):
            w0, z, y0, rho, it, _, _, _, _, best = carry
            if settings.adaptive_rho:
                rho_seg = _rho_groups(settings, rho, s)
                fac_seg = factor(rho)
            else:
                rho_seg, fac_seg = rho_g, fac
            w, z, y, _, _ = jax.lax.fori_loop(
                0, settings.check_interval, admm_iter,
                (w0, z, y0, rho_seg, fac_seg))
            it = it + settings.check_interval

            (prim, dual, done, status,
             prim_scale, dual_scale) = check_segment(w0, y0, w, z, y)

            if settings.adaptive_rho:
                ratio = rho_ratio(prim, dual, prim_scale, dual_scale)
                new_rho = jnp.clip(rho * ratio, 1e-6, 1e6)
                trigger = ((ratio > settings.adaptive_rho_tol)
                           | (ratio < 1.0 / settings.adaptive_rho_tol)) & ~done
                rho = jnp.where(trigger, new_rho, rho)
            best = update_best(best, w, z, y, prim, dual)
            done = done | stalled(best)
            return w, z, y, rho, it, prim, dual, done, status, best

        def loop_cond(carry):
            _, _, _, _, it, _, _, done, _, _ = carry
            return (~done) & (it < n_segments * settings.check_interval)

        init = (w, z, y, rho0,
                jnp.zeros((), jnp.int32), inf0, inf0,
                jnp.asarray(False), jnp.zeros((), jnp.int32), best0)
        (w, z, y, _, it, prim, dual, done, status,
         best) = jax.lax.while_loop(loop_cond, segment, init)

    stall_exit = stalled(best) & (status == STATUS_MAX_ITER)
    # adopt the best-so-far iterate where it beats the final one
    wb, zb, yb, pb, db, _ = best
    adopt = jnp.maximum(pb, db) < jnp.maximum(prim, dual)
    takeb = lambda a, b: jnp.where(adopt, a, b)
    w = _wmap(takeb, wb, w)
    z = _zmap(takeb, zb, z)
    y = _zmap(takeb, yb, y)
    prim = jnp.where(adopt, pb, prim)
    dual = jnp.where(adopt, db, dual)

    better = jnp.asarray(False)
    if settings.polish:
        w_p, z_p, y_p, y_lo = _polish(s, settings, sigma, factorize,
                                      backsolve, w, y, nx, nu)
        (prim_p, dual_p, eps_prim_p, eps_dual_p,
         _, _) = _residuals(s, settings, w_p, z_p, y_p, y_lo)
        # Acceptance: keep the polished iterate if its NORMALIZED worst
        # residual max(prim/eps_prim, dual/eps_dual) improves.  OSQP's
        # both-must-improve gate is a knife-edge here: the ADMM primal
        # is already at the f32 floor (~e-7), so 'prim_p < prim' flips
        # on roundoff noise -- measured as lanes polishing on one
        # factorization backend but not the other, widening a
        # backend-vs-backend parity band to the unpolished error
        # (u_err 0.08).  The normalized gate keeps OSQP's protection --
        # a weakly-active row pinned by mistake shows up as a primal
        # residual far above eps_prim and still rejects -- while a
        # dual improvement of 10x+ is never vetoed by one ulp of
        # primal noise.
        worst = jnp.maximum(prim / eps_prim_p, dual / eps_dual_p)
        worst_p = jnp.maximum(prim_p / eps_prim_p, dual_p / eps_dual_p)
        better = worst_p < worst
        pick = lambda a, b: jnp.where(better, a, b)
        w = _wmap(pick, w_p, w)
        z = _zmap(pick, z_p, z)
        y = _zmap(pick, y_p, y)
        prim = jnp.where(better, prim_p, prim)
        dual = jnp.where(better, dual_p, dual)
        newly = better & (prim_p < eps_prim_p) & (dual_p < eps_dual_p)
        done = done | newly
        status = jnp.where(newly, STATUS_SOLVED, status).astype(jnp.int32)

    del done  # loop-exit flag; includes infeasible exits
    status = jnp.asarray(status, jnp.int32)
    w_un = _wmap(lambda a, d: a * d, w, s.D)
    y_un = _zmap(lambda a, e: a * e / s.c, y, s.E)
    return BlockQPSolution(X=w_un.x, U=w_un.u, t=w_un.t, y=y_un,
                           iterations=it, prim_res=prim, dual_res=dual,
                           converged=(status == STATUS_SOLVED),
                           status=status, stalled=stall_exit,
                           polished=better)
