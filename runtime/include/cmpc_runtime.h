/* cmpc_runtime: native host-side runtime for the centroidal MPC.
 *
 * The JAX/XLA side owns all device compute (linearization, QP, SCP).  This
 * library owns the host realtime path around it, replacing the reference's
 * filesystem-and-Python glue (npz handoffs, 1 kHz Python control loop in
 * src/simulate_solo.py:281-309) with:
 *
 *   - trajectory bus: a seqlock-protected double buffer through which the
 *     solver thread publishes (t0, X, U, K) plans and a control thread
 *     reads consistently interpolated (x_ref, u_ff, K) samples at any
 *     query time, wait-free for the reader in the common case;
 *   - control-rate interpolation: linear state/control interpolation
 *     between planning knots (the reference's interpolate_SCP_solution
 *     semantics, src/scp_solver.py:95-111, evaluated on demand instead of
 *     precomputed);
 *   - contact-plan expansion: gait spec -> dense per-knot schedule,
 *     mirroring contact/plan.py (reference src/contact_plan.py:112-264);
 *   - rt scheduler: a periodic tick helper with absolute-deadline
 *     clock_nanosleep and jitter accounting for the 1 kHz loop.
 *
 * Pure C API for ctypes binding.  All buffers are caller-owned double
 * arrays; layouts are row-major, knot-major (matching the Python side).
 */
#ifndef CMPC_RUNTIME_H_
#define CMPC_RUNTIME_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ------------------------------ trajectory bus ------------------------- */

typedef struct cmpc_bus cmpc_bus;

/* Create a bus for plans with `horizon` knots (X has horizon+1), state
 * dimension nx, control dimension nu, planning step dt. */
cmpc_bus* cmpc_bus_create(int horizon, int nx, int nu, double dt);
void cmpc_bus_destroy(cmpc_bus* bus);

/* Publish a plan starting at time t0.  X: (horizon+1, nx); U: (horizon,
 * nu); K: (horizon, nu, nx) feedback gains (may be NULL -> zeros).
 * Thread-safe against concurrent readers (seqlock); single writer. */
void cmpc_bus_publish(cmpc_bus* bus, double t0, const double* X,
                      const double* U, const double* K);

/* Sample the current plan at absolute time t: writes x_ref (nx), u_ff
 * (nu) and k_fb (nu*nx).  States interpolate linearly between knots;
 * controls and gains are zero-order-hold (the reference interpolates both
 * linearly for states/controls at 10x, src/scp_solver.py:95-111; ZOH on
 * u matches its sim usage of per-knot forces).  Clamps beyond the ends.
 * Returns the number of writer updates observed (plan version), or -1 if
 * no plan was ever published. */
int64_t cmpc_bus_sample(const cmpc_bus* bus, double t, double* x_ref,
                        double* u_ff, double* k_fb);

/* ---------------------------- contact planning ------------------------- */

/* Expand a gait into the dense per-knot schedule.
 *
 * gait_type: 0=TROT, 1=PACE, 2=BOUND (reference src/contact_plan.py:115).
 * n_contacts: 4 (quadruped, order FR,FL,HR,HL) or 2 (biped, order RF,LF).
 * feet0: (n_contacts, 3) initial placements.
 * Outputs (caller-allocated, sized for the horizon returned by
 * cmpc_plan_horizon): logic (N, C), pos (N, C, 3), rot (N, C, 9).
 * Returns the number of knots written, or -1 on invalid input. */
int cmpc_expand_contact_plan(int gait_type, double step_length,
                             int step_knots, int support_knots, int nb_steps,
                             int n_contacts, const double* feet0,
                             double* logic, double* pos, double* rot);

/* Number of knots the expansion will produce (for buffer sizing). */
int cmpc_plan_horizon(int gait_type, int step_knots, int support_knots,
                      int nb_steps);

/* ------------------------------ rt scheduler --------------------------- */

typedef struct cmpc_ticker cmpc_ticker;

/* Absolute-deadline periodic ticker with period_ns nanoseconds. */
cmpc_ticker* cmpc_ticker_create(int64_t period_ns);
void cmpc_ticker_destroy(cmpc_ticker* t);

/* Sleep until the next tick deadline.  Returns the lateness (ns) of the
 * wakeup relative to the deadline (>= 0; large values indicate overruns;
 * missed deadlines skip forward). */
int64_t cmpc_ticker_wait(cmpc_ticker* t);

/* Jitter statistics since creation: count, max lateness ns, mean ns. */
void cmpc_ticker_stats(const cmpc_ticker* t, int64_t* count,
                       int64_t* max_late_ns, double* mean_late_ns);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* CMPC_RUNTIME_H_ */
