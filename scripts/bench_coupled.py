"""Coupled-step timing at ~1M nodes for the BASELINE '>= 30x vs 64-thread
OpenMP' comparison.

Times, on the device JAX finds, at the bench geometry (2D, dx=1um, ~0.9M nodes,
baseline physics):
  - one steady-flow iteration (BCs + ns_step + wall BC), amortized in a
    fused device loop
  - operator assemble (once per coupling cycle)
  - one implicit transport step (adaptive dt + BCs + GMRES + smoothing)

The reference counterpart is /tmp/refbuild/bench_ref (same config, same
grid, OMP_NUM_THREADS as chosen); results recorded in docs/PARITY.md.

Usage: python scripts/bench_coupled.py [dx]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)  # refinement needs f64 available

import jax.numpy as jnp
import numpy as np


def main():
    dx = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0e-6

    from pd_mg_pin_corrosion_tpu import boundary as bc
    from pd_mg_pin_corrosion_tpu.config import Config
    from pd_mg_pin_corrosion_tpu.coupling import implicit_inner_step
    from pd_mg_pin_corrosion_tpu.fields import initialize_state
    from pd_mg_pin_corrosion_tpu.grid import build_grid
    from pd_mg_pin_corrosion_tpu.kit import build_kit
    from pd_mg_pin_corrosion_tpu.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu.ops.ns import compute_dt
    from pd_mg_pin_corrosion_tpu.pallas_kernels import ns_step_auto

    cfg = Config.load("config/params.cfg")
    cfg.dx = dx
    cfg.L_upstream = 500.0e-6
    cfg.L_downstream = 500.0e-6
    cfg.precision = "f32"
    cfg.compute_derived()

    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)
    print(f"grid {grid.shape} N={grid.N_total} S={grid.stencil.size}",
          flush=True)

    dt = compute_dt(state, kit)

    @jax.jit
    def flow_iters(s, dt, n):
        def body(_, ss):
            ss = bc.apply_inlet_bc(ss, kit)
            ss = bc.apply_outlet_bc(ss, kit)
            ss = bc.apply_wall_bc(ss, kit)
            ss = bc.apply_solid_surface_bc(ss, kit)
            ss = ns_step_auto(ss, kit, dt)
            return bc.apply_wall_bc(ss, kit)
        return jax.lax.fori_loop(0, n, body, s)

    def sync(x):
        return float(jnp.sum(x))

    sync(flow_iters(state, dt, 10).rho)
    sync(flow_iters(state, dt, 110).rho)
    best = float("inf")
    for _ in range(3):
        t0 = time.time(); sync(flow_iters(state, dt, 10).rho); lo = time.time() - t0
        t0 = time.time(); sync(flow_iters(state, dt, 110).rho); hi = time.time() - t0
        best = min(best, (hi - lo) / 100)
    print(f"flow_iter_ms={best * 1e3:.3f}", flush=True)

    op = jax.jit(ai.assemble)(state, kit, 0.0)
    sync(op.diag)
    t0 = time.time()
    op = jax.jit(ai.assemble)(state, kit, 0.0)
    sync(op.diag)
    print(f"assemble_s={time.time() - t0:.3f}", flush=True)

    # full implicit inner step (adaptive dt + BCs + GMRES + smoothing)
    s2, dtc, dis, res, diag = implicit_inner_step(state, op, kit)
    sync(s2.C)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        s2, dtc, dis, res, diag = implicit_inner_step(state, op, kit)
        sync(s2.C)
        best = min(best, time.time() - t0)
    print(f"implicit_step_s={best:.3f}  dt={float(dtc):.3e}  "
          f"gmres_res={float(res):.2e}", flush=True)


if __name__ == "__main__":
    main()
