"""QP assembly for one SCP subproblem.

The reference assembles a sparse QP on the host with scipy + Python loops
over knots and contacts (src/cost.py, src/constraints.py), with variables
flattened through the index-bookkeeping layer (src/optimizer.py).  Here the
assembly is a single jitted program of vectorized scatters: all per-knot
blocks are computed at once and written into the dense OSQP-form arrays

    min 1/2 z' P z + q' z    s.t.  l <= A z <= u

with the same decision-vector layout as the reference
(src/centroidal_model.py:25-26):

    z = [ X (knot-major, nx*(N+1)) | U (knot-major, nu*N)
        | t_state (N+1) | t_ctrl (N) ]

and the same row ordering (src/scp_solver.py:28-48):

    [ initial (nx) | dynamics (nx*N) | final (nx) | cop (wrench6 only)
    | friction (C*5*N) | trust-l1 (2^3*(N+1)) | trust-slack (N+1) ]

so a dense diff against the reference's csc matrices is exact.

The dense (P, q, A, l, u) is consumed by the ADMM solver in ops/admm.py;
the block quantities remain available for future structure-exploiting
(Pallas block-banded) solver paths.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from centroidal_mpc_tpu.config.robots import POINT3, RobotSpec
from centroidal_mpc_tpu.contact.plan import ContactSchedule
from centroidal_mpc_tpu.models.centroidal import (CentroidalModel, N_X,
                                                  TrajectoryData)
from centroidal_mpc_tpu.utils import struct
from centroidal_mpc_tpu.utils.precision import highest_precision

INF = 1e20  # OSQP-style infinity; keeps arrays finite for f32 TPU math

# Reference dynamics-row feasibility slack (src/constraints.py:45-47).
DYN_SLACK = 1e-12


def friction_pyramid_matrix(mu: float, dtype=jnp.float64) -> jnp.ndarray:
    """Inner linear approximation of the friction cone, 5 rows:
    4 tangential + unilateral (reference src/utils.py:9-16)."""
    mu_lin = mu / np.sqrt(2.0)
    # numpy return: becomes a jit closure constant (no device-to-host
    # copy at lowering -- see contact/plan.py)
    return np.asarray(
        [[1.0, 0.0, -mu_lin],
         [-1.0, 0.0, -mu_lin],
         [0.0, 1.0, -mu_lin],
         [0.0, -1.0, -mu_lin],
         [0.0, 0.0, -1.0]], dtype=dtype)


def sign_enumeration_matrix(n: int, dtype=jnp.float64) -> jnp.ndarray:
    """(2^n, n) matrix of +-1 sign patterns for the L1 trust region,
    column j = (-1)^(row // 2^j) (reference src/optimizer.py:111-112)."""
    rows = np.arange(2**n)[:, None]
    cols = 2 ** np.arange(n)[None, :]
    return np.asarray((-1.0) ** (rows // cols), dtype=dtype)


class OcpConfig(struct.PyTreeNode):
    """Per-problem data for QP assembly (pytree; traced quantities only)."""

    x_init: jnp.ndarray          # (nx,)
    x_final: jnp.ndarray         # (nx,)
    X_track: jnp.ndarray         # (N+1, nx) tracking reference (DDP warm start)
    Wx: jnp.ndarray              # (nx, nx) state cost weights
    Wu: jnp.ndarray              # (nu, nu) control cost weights
    pyramid: jnp.ndarray         # (5, 3) friction pyramid matrix
    xi: jnp.ndarray              # chance-constraint quantile Phi^-1(1-beta')
    cop_range: jnp.ndarray       # (2, 2): [[lxp, lxn], [lyp, lyn]] (wrench6)
    # --- static switches (affect program structure) ---
    track_state: bool = struct.field(pytree_node=False, default=True)
    stochastic: bool = struct.field(pytree_node=False, default=False)
    # False relaxes the final-state equality to free rows (receding-horizon
    # MPC: the tracking cost provides the terminal pull; an exact terminal
    # equality from a disturbed measured state is routinely infeasible)
    terminal_equality: bool = struct.field(pytree_node=False, default=True)
    # Reference leaves the unilateral (5th) pyramid row unfilled
    # (src/constraints.py:180 loops range(4)); set True to also enforce
    # fz >= 0 explicitly (SURVEY.md section 2b "replicate-or-fix").
    fill_unilateral: bool = struct.field(pytree_node=False, default=False)


class QPData(struct.PyTreeNode):
    """Dense OSQP-form problem data."""

    P: jnp.ndarray
    q: jnp.ndarray
    A: jnp.ndarray
    l: jnp.ndarray
    u: jnp.ndarray


def qp_dims(model: CentroidalModel, N: int):
    """(n_vars, row-segment offsets) for the reference layout."""
    nx, nu, c = N_X, model.n_u, model.n_contacts
    n = nx * (N + 1) + nu * N + (N + 1) + N
    m_cop = 2 * c * N if model.contact_model != POINT3 else 0
    segs = dict(initial=nx, dynamics=nx * N, final=nx, cop=m_cop,
                friction=c * 5 * N, trust=8 * (N + 1), slack=N + 1)
    return n, segs


def _offsets(segs):
    off, acc = {}, 0
    for k, v in segs.items():
        off[k] = acc
        acc += v
    return off, acc


@highest_precision
def build_qp(model: CentroidalModel, schedule: ContactSchedule,
             cfg: OcpConfig, X_prev: jnp.ndarray, U_prev: jnp.ndarray,
             data: TrajectoryData, radius: jnp.ndarray,
             weight: jnp.ndarray) -> QPData:
    """Assemble the dense QP for one SCP iteration.

    X_prev/U_prev: linearization trajectory; data: its TrajectoryData;
    radius/weight: current trust-region state (traced scalars, so the jitted
    assembly is reused across SCP iterations).
    """
    N = U_prev.shape[0]
    nx, nu, C = N_X, model.n_u, model.n_contacts
    nuc = model.n_u_per_contact
    dtype = X_prev.dtype
    n, segs = qp_dims(model, N)
    off_row, m = _offsets(segs)
    off_x, off_u = 0, nx * (N + 1)
    off_tx = off_u + nu * N

    # ---------------- cost ----------------
    # Block-diag kron of per-knot weights (reference src/cost.py:9-16).
    P = jnp.zeros((n, n), dtype)
    P = P.at[:off_u, :off_u].set(jnp.kron(jnp.eye(N + 1, dtype=dtype), cfg.Wx))
    P = P.at[off_u:off_tx, off_u:off_tx].set(
        jnp.kron(jnp.eye(N, dtype=dtype), cfg.Wu))
    q = jnp.zeros(n, dtype)
    if cfg.track_state:
        # -Wx @ x_ref per knot (reference src/cost.py:21-29).
        q = q.at[:off_u].set((-(cfg.X_track @ cfg.Wx.T)).reshape(-1))
    # L1 exact-penalty cost on the state slacks (src/cost.py:34-39).
    q = q.at[off_tx:off_tx + N + 1].set(1.0)

    A = jnp.zeros((m, n), dtype)
    l = jnp.full(m, -INF, dtype)
    u = jnp.full(m, INF, dtype)

    # ---------------- boundary conditions ----------------
    r0 = off_row["initial"]
    A = A.at[r0:r0 + nx, 0:nx].set(jnp.eye(nx, dtype=dtype))
    l = l.at[r0:r0 + nx].set(cfg.x_init)
    u = u.at[r0:r0 + nx].set(cfg.x_init)
    rf = off_row["final"]
    A = A.at[rf:rf + nx, N * nx:(N + 1) * nx].set(jnp.eye(nx, dtype=dtype))
    if cfg.terminal_equality:
        l = l.at[rf:rf + nx].set(cfg.x_final)
        u = u.at[rf:rf + nx].set(cfg.x_final)

    # ---------------- linearized dynamics ----------------
    # A_k x_k + B_k u_k - x_{k+1} = A_k xbar_k + B_k ubar_k - f_k
    # (reference src/constraints.py:36-49), vectorized scatters over knots.
    rd = off_row["dynamics"]
    k_idx = jnp.arange(N)
    row_base = rd + k_idx * nx                                  # (N,)
    ri = row_base[:, None, None] + jnp.arange(nx)[None, :, None]
    cxj = (k_idx * nx)[:, None, None] + jnp.arange(nx)[None, None, :]
    cuj = (off_u + k_idx * nu)[:, None, None] + jnp.arange(nu)[None, None, :]
    cx1 = ((k_idx + 1) * nx)[:, None, None] + jnp.arange(nx)[None, None, :]
    A = A.at[jnp.broadcast_to(ri, data.A.shape),
             jnp.broadcast_to(cxj, data.A.shape)].set(data.A)
    A = A.at[jnp.broadcast_to(ri, data.B.shape),
             jnp.broadcast_to(cuj, data.B.shape)].set(data.B)
    minus_eye = jnp.broadcast_to(-jnp.eye(nx, dtype=dtype), (N, nx, nx))
    A = A.at[jnp.broadcast_to(ri, minus_eye.shape),
             jnp.broadcast_to(cx1, minus_eye.shape)].set(minus_eye)
    resid = (jnp.einsum("kij,kj->ki", data.A, X_prev[:-1])
             + jnp.einsum("kij,kj->ki", data.B, U_prev) - data.f).reshape(-1)
    l = l.at[rd:rd + nx * N].set(resid - DYN_SLACK)
    u = u.at[rd:rd + nx * N].set(resid + DYN_SLACK)

    # ---------------- CoP box (wrench6 only) ----------------
    if model.contact_model != POINT3:
        # Per contact: N rows (cop_x) then N rows (cop_y)
        # (reference src/constraints.py:111-145).  Inactive rows zero, 0<=0.
        rc = off_row["cop"]
        logic = schedule.logic  # (N, C)
        for axis in range(2):
            rows = (rc + jnp.arange(C)[:, None] * 2 * N + axis * N
                    + k_idx[None, :])                            # (C, N)
            cols = (off_u + k_idx[None, :] * nu
                    + jnp.arange(C)[:, None] * nuc + axis)       # (C, N)
            A = A.at[rows, cols].set(logic.T)
            lo = jnp.where(logic.T > 0, -cfg.cop_range[axis, 1], 0.0)
            hi = jnp.where(logic.T > 0, cfg.cop_range[axis, 0], 0.0)
            l = l.at[rows.reshape(-1)].set(lo.reshape(-1))
            u = u.at[rows.reshape(-1)].set(hi.reshape(-1))

    # ---------------- friction pyramid ----------------
    # Rotated pyramid G R' per active contact/knot; reference fills only the
    # 4 tangential rows (src/constraints.py:180), leaving the unilateral row
    # all-zero.  Row index within contact block: k*5 + row; contact blocks
    # are stacked contact-major (src/constraints.py:169-217).
    rfr = off_row["friction"]
    n_rows = 5
    rot_pyr = jnp.einsum("ri,kcji->kcrj", cfg.pyramid,
                         schedule.orientation)    # (N, C, 5, 3) = G @ R^T
    rot_pyr = rot_pyr * schedule.logic[:, :, None, None]
    if not cfg.fill_unilateral:
        rot_pyr = rot_pyr.at[:, :, 4, :].set(0.0)
    fric_rows = (rfr + jnp.arange(C)[None, :, None, None] * (n_rows * N)
                 + k_idx[:, None, None, None] * n_rows
                 + jnp.arange(n_rows)[None, None, :, None])      # (N,C,5,1)
    force_col0 = off_u + k_idx * nu                              # (N,)
    fcol_in_contact = (jnp.arange(C) * nuc
                       + (0 if model.contact_model == POINT3 else 2))
    fric_cols = (force_col0[:, None, None, None]
                 + fcol_in_contact[None, :, None, None]
                 + jnp.arange(3)[None, None, None, :])           # (N,C,1,3)
    A = A.at[jnp.broadcast_to(fric_rows, rot_pyr.shape),
             jnp.broadcast_to(fric_cols, rot_pyr.shape)].set(rot_pyr)
    ub_fric = jnp.zeros((N, C, n_rows), dtype)
    if cfg.stochastic:
        ub_fric = ub_fric - _chance_backoffs(model, cfg, data, rot_pyr)
    # scatter ub (lb stays -inf, reference src/constraints.py:217)
    u = u.at[fric_rows[..., 0]].set(ub_fric)

    # ---------------- state trust region (L1 exact penalty) ----------------
    # +-1 sign enumeration over angular momentum (rows) with slack relief
    # t_k / weight (reference src/constraints.py:260-293):
    #   penum @ (x_ang - xbar_ang) - t_k / weight <= radius
    rt = off_row["trust"]
    penum = sign_enumeration_matrix(3, dtype)                     # (8, 3)
    kk = jnp.arange(N + 1)
    t_rows = (rt + kk[:, None, None] * 8
              + jnp.arange(8)[None, :, None])                     # (N+1,8,1)
    ang_cols = (kk * nx)[:, None, None] + 6 + jnp.arange(3)[None, None, :]
    pen_b = jnp.broadcast_to(penum[None], (N + 1, 8, 3))
    A = A.at[jnp.broadcast_to(t_rows, pen_b.shape),
             jnp.broadcast_to(ang_cols, pen_b.shape)].set(pen_b)
    slack_cols = off_tx + kk                                      # (N+1,)
    A = A.at[t_rows[:, :, 0],
             jnp.broadcast_to(slack_cols[:, None], (N + 1, 8))].set(
                 -1.0 / weight)
    ub_trust = radius + X_prev[:, 6:9] @ penum.T                  # (N+1, 8)
    u = u.at[rt:rt + 8 * (N + 1)].set(ub_trust.reshape(-1))
    # -t_k <= 0 (src/constraints.py:287-289)
    rs = off_row["slack"]
    A = A.at[rs + kk, slack_cols].set(-1.0)
    u = u.at[rs:rs + N + 1].set(0.0)

    return QPData(P=P, q=q, A=A, l=l, u=u)


def _chance_backoffs(model: CentroidalModel, cfg: OcpConfig,
                     data: TrajectoryData, rot_pyr: jnp.ndarray):
    """Individual chance-constraint back-offs xi * 2 G_ij sqrt((K S K')_jj).

    Reference (src/constraints.py:187-214) also adds dSigma/dz linearization
    terms, but those are computed from the Covs_gradients tensors which are
    *identically zero* by construction (jacrev of a constant,
    src/centroidal_model.py:239-240; SURVEY.md section 2b) -- so only the
    constant back-off survives.  We therefore compute exactly that term:
    per row i, sum over control dims j with G_ij > 1e-6 and sqrt > 1e-6, for
    knots k > 0.
    """
    N, C = rot_pyr.shape[0], rot_pyr.shape[1]
    nuc3 = 3
    # K rows of each contact's force block: (N, C, 3, nx)
    if model.contact_model == POINT3:
        K_c = data.K.reshape(N, C, nuc3, N_X)
    else:
        K_c = data.K.reshape(N, C, 6, N_X)[:, :, 2:5, :]
    # (K Sigma K')_jj per contact: (N, C, 3)
    KS = jnp.einsum("kcjx,kxy->kcjy", K_c, data.Sigma[:N])
    ksk_diag = jnp.einsum("kcjy,kcjy->kcj", KS, K_c)
    sqrt_ksk = jnp.sqrt(jnp.maximum(ksk_diag, 0.0))
    G = rot_pyr[:, :, :, :]                                     # (N, C, 5, 3)
    gate = ((G > 1e-6) & (sqrt_ksk[:, :, None, :] > 1e-6)).astype(G.dtype)
    backoff = cfg.xi * 2.0 * jnp.sum(G * sqrt_ksk[:, :, None, :] * gate,
                                     axis=-1)                   # (N, C, 5)
    # no back-off at knot 0 (reference src/constraints.py:187 `time_idx>0`)
    return backoff.at[0].set(0.0)
