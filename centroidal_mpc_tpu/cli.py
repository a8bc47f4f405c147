"""Console entry points (pyproject [project.scripts]).

The reference ships as an installable package (reference setup.py:1-7)
whose entry points are demo notebooks/scripts; here the same surfaces are
`cmpc-run-motion` (the end-to-end pipeline, reference
build/lib/demos/run_motion.py:16-143) and `cmpc-server` (the deployment
topology: solver thread + 1 kHz control thread over the native bus).
The `demos/*.py` scripts are thin shims over these functions so the repo
also runs uninstalled.
"""
import argparse


def run_motion_main(argv=None):
    """End-to-end motion demo: warm start -> nominal SCP -> stochastic SCP
    -> Monte-Carlo evaluation -> artifacts + plots + HTML motion preview."""
    ap = argparse.ArgumentParser(description=run_motion_main.__doc__)
    ap.add_argument("--preset", default="solo12_trot")
    ap.add_argument("--sims", type=int, default=16,
                    help="Monte-Carlo rollouts (0 disables)")
    ap.add_argument("--out", default="artifacts/demo")
    ap.add_argument("--nominal-only", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--f64", action="store_true",
                    help="float64 (CPU reference mode)")
    ap.add_argument("--whole-body", choices=["kinematic", "ddp"],
                    default="kinematic",
                    help="stage-3 layer: closed-form IK or joint-space DDP "
                         "over the rigid-body contact dynamics")
    ap.add_argument("--physics-sims", type=int, default=0,
                    help="full-physics Monte-Carlo episodes (0 disables)")
    ap.add_argument("--qp-backend", choices=["block", "dense"],
                    default="block",
                    help="block = structure-exploiting production solver; "
                         "dense = reference-layout path (slow at N=165)")
    ap.add_argument("--terrain", choices=["flat", "debris"], default="flat",
                    help="debris = the reference's per-gait stepstone "
                         "terrain (GAIT='..._ON_DEBRI', "
                         "src/simulate_solo.py:217-256): tilted footholds "
                         "in the plan + stones in the physics plant")
    ap.add_argument("--no-preview", action="store_true",
                    help="skip the standalone HTML 3D motion preview")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.pipeline import run_pipeline
    from centroidal_mpc_tpu.utils.artifacts import ArtifactStore
    from centroidal_mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    preset = presets.PRESETS[args.preset]
    terrain = None
    if args.terrain == "debris":
        from centroidal_mpc_tpu.contact import terrain as ter
        terrain = ter.DEBRIS_BY_GAIT[preset.gait.gait_type]
    store = ArtifactStore(args.out)
    dtype = jnp.float64 if args.f64 else jnp.float32

    print(f"[pipeline] preset={preset.name} N={preset.horizon} "
          f"device={jax.devices()[0].device_kind} dtype={dtype.__name__}")
    result = run_pipeline(preset, store, stochastic=not args.nominal_only,
                          n_sims=args.sims, dtype=dtype,
                          whole_body_mode=args.whole_body,
                          physics_sims=args.physics_sims,
                          qp_backend=args.qp_backend, terrain=terrain)

    nom = result.nominal
    print(f"[nominal]   success={bool(nom.success)} "
          f"scp_iters={int(nom.iterations)} qp_iters={int(nom.qp_iterations)} "
          f"rho={float(nom.rho):.2e}")
    if result.stochastic is not None:
        sto = result.stochastic
        print(f"[stochastic] success={bool(sto.success)} "
              f"scp_iters={int(sto.iterations)} "
              f"qp_iters={int(sto.qp_iterations)}")
    if result.eval_stats:
        nv = result.eval_stats.get("nominal_violations")
        if nv is not None:
            print(f"[monte-carlo] sims={args.sims} "
                  f"nominal cone violations/sim={np.mean(nv):.1f}")
    if result.wb_ddp is not None:
        print(f"[whole-body ddp] cost={float(result.wb_ddp.cost):.3f} "
              f"iters={int(result.wb_ddp.iterations)}")
    if result.mc_physics is not None:
        slip = result.eval_stats["physics_slippage"]
        fell = result.eval_stats["physics_fell"]
        print(f"[physics mc] sims={args.physics_sims} "
              f"fell={int(fell.sum())}/{len(fell)} "
              f"slip mean={float(np.mean(slip)):.3f} m")

    # figures (matplotlib is the optional `plots` extra)
    try:
        from centroidal_mpc_tpu.sim import plots
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print("[figures] skipped: matplotlib (the `plots` extra) is not "
              "installed")
        plots = None
    if plots is not None:
        _draw_figures(plots, result, preset, args.out)
    if not args.no_preview:
        from centroidal_mpc_tpu.sim.preview import write_motion_preview
        path = write_motion_preview(result, preset, args.out)
        print(f"[preview] 3D motion preview: {path}")
    print(f"[artifacts] written to {args.out}/")
    return result


def _draw_figures(plots, result, preset, out):
    """The reference's evaluation figures for one pipeline result."""
    import numpy as np

    from centroidal_mpc_tpu.contact.swing import compute_swing_trajectories

    nom = result.nominal
    prob = result.problem
    U_sto = (np.asarray(result.stochastic.U)
             if result.stochastic is not None else None)
    plots.plot_contact_forces(preset.robot.foot_names, np.asarray(nom.U),
                              U_sto, preset.dt, preset.mu, save_dir=out)
    plots.plot_centroidal_trajectory(np.asarray(nom.X), result.warm_X,
                                     preset.dt, save_dir=out)
    if result.eval_stats:
        plots.plot_tracking_cost(result.eval_stats, preset.dt,
                                 save_dir=out)
    swing = compute_swing_trajectories(prob.plan, preset.dt_ctrl)
    plots.plot_swing_trajectories(swing, preset.robot.foot_names,
                                  preset.dt_ctrl, save_dir=out)
    if "physics_slippage_series" in result.eval_stats:
        plots.plot_foot_slippage(
            {"nominal": result.eval_stats["physics_slippage_series"]},
            preset.dt_ctrl, save_dir=out)
    if result.wb_traj is not None:
        plots.plot_whole_body_solution(
            np.asarray(result.wb_traj.q), np.asarray(result.wb_traj.qdot),
            np.asarray(result.wb_traj.tau_ff), preset.dt_ctrl,
            foot_names=preset.robot.foot_names,
            base_pos=np.asarray(result.wb_traj.base_pos),
            save_dir=out)


def mpc_server_main(argv=None):
    """MPC runtime demo: solver thread + 1 kHz control thread over the
    native trajectory bus (the deployment topology the reference
    approximates with npz files + a free-running Python loop,
    src/simulate_solo.py:281-309)."""
    import threading
    import time

    ap = argparse.ArgumentParser(description=mpc_server_main.__doc__)
    ap.add_argument("--preset", default="solo12_trot_n50")
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--resolves", type=int, default=3,
                    help="number of SCP re-solves to publish")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.models.centroidal import (CentroidalModel,
                                                      dynamics_step)
    from centroidal_mpc_tpu.ops.admm import QPSettings
    from centroidal_mpc_tpu.runtime import native
    from centroidal_mpc_tpu.solver.scp import solve_scp

    preset = presets.PRESETS[args.preset]
    # f32-appropriate solver tolerances (see bench.py)
    prob = presets.build_problem(
        preset, dtype=jnp.float32,
        qp=QPSettings(eps_abs=5e-4, eps_rel=5e-4, max_iter=4000,
                      adaptive_rho=False))
    N, nx, nu = prob.plan.horizon, 9, preset.robot.n_u
    bus = native.TrajectoryBus(N, nx, nu, preset.dt)

    solve = jax.jit(lambda c, x, u: solve_scp(
        prob.model, prob.plan.schedule, c, x, u, prob.scp))

    stop = threading.Event()
    solve_times = []

    def solver_thread():
        x_init = prob.X0
        for i in range(args.resolves):
            if stop.is_set():
                return
            t0 = time.perf_counter()
            sol = solve(prob.ocp, x_init, prob.U0)
            jax.block_until_ready(sol.X)
            solve_times.append(time.perf_counter() - t0)
            bus.publish(0.0, np.asarray(sol.X, np.float64),
                        np.asarray(sol.U, np.float64),
                        np.asarray(sol.K, np.float64))

    st = threading.Thread(target=solver_thread)
    st.start()

    # control loop: wait for the first plan, then tick at dt_ctrl
    while bus.sample(0.0)[0] < 0 and st.is_alive():
        time.sleep(0.001)
    tick = native.Ticker(period_s=preset.dt_ctrl)
    # plant integrates at the control rate: same centroidal model, dt_ctrl
    model_ctrl = prob.model.replace(dt=jnp.asarray(preset.dt_ctrl,
                                                   jnp.float32))
    step = jax.jit(lambda x, u, k: dynamics_step(
        model_ctrl, x, u, prob.plan.schedule.position[k],
        prob.plan.schedule.logic[k], prob.plan.schedule.orientation[k]))

    x = np.asarray(prob.X0[0], np.float64)
    track_err = []
    n_inner = int(round(preset.dt / preset.dt_ctrl))
    # stay within the plan: beyond N*dt the bus clamps to the final knot
    # (a receding-horizon deployment would re-solve and re-publish instead)
    n_ticks = min(args.ticks, N * n_inner)
    for i in range(n_ticks):
        tick.wait()
        t = i * preset.dt_ctrl
        version, x_ref, u_ff, k_fb = bus.sample(t)
        u = u_ff + k_fb @ (x - x_ref)
        track_err.append(float(np.linalg.norm(x - x_ref)))
        k = min(i // n_inner, N - 1)
        x = np.asarray(step(jnp.asarray(x, jnp.float32),
                            jnp.asarray(u, jnp.float32), k), np.float64)
    stop.set()
    st.join()

    stats = tick.stats()
    print(f"[solver ] {len(solve_times)} solves, "
          f"latency min/mean = {min(solve_times)*1e3:.1f}/"
          f"{np.mean(solve_times)*1e3:.1f} ms")
    print(f"[control] {stats['ticks']} ticks @ {preset.dt_ctrl*1e3:.1f} ms, "
          f"wakeup lateness mean/max = {stats['mean_late_ns']/1e3:.0f}us/"
          f"{stats['max_late_ns']/1e3:.0f}us")
    print(f"[tracking] mean |x - x_ref| = {np.mean(track_err):.4f}, "
          f"final = {track_err[-1]:.4f}")
