#!/usr/bin/env python
"""MPC runtime demo (thin shim over centroidal_mpc_tpu.cli).

Solver thread + 1 kHz control thread over the native trajectory bus --
the deployment topology the reference approximates with npz files and a
free-running Python loop (src/simulate_solo.py:281-309):

  solver thread:  jitted SCP solves (GPU/CPU) -> cmpc_bus_publish
  control thread: native deadline ticker at dt_ctrl -> cmpc_bus_sample ->
                  closed-loop centroidal step with the sampled LQR gains

Prints solve latency, control-tick jitter, and tracking error.

    python demos/mpc_server.py --ticks 2000 --cpu

Installed form (pip install -e .):  cmpc-server --ticks 2000 --cpu
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from centroidal_mpc_tpu.cli import mpc_server_main

if __name__ == "__main__":
    mpc_server_main()
