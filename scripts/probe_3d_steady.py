"""Probe: 3D steady-flow convergence (stabilization study driver).

Runs solve_steady on the params_3d geometry at a given dx and eta_density,
printing convergence telemetry. Usage:
    python scripts/probe_3d_steady.py [dx] [eta_density] [max_iters]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np


def main():
    dx = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0e-6
    eta = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    max_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 60000

    from pd_mg_pin_corrosion_tpu.config import Config
    from pd_mg_pin_corrosion_tpu.fields import initialize_state
    from pd_mg_pin_corrosion_tpu.grid import FLUID, build_grid
    from pd_mg_pin_corrosion_tpu.kit import build_kit
    from pd_mg_pin_corrosion_tpu.solvers import solve_steady

    cfg = Config.load("config/params_3d.cfg")
    cfg.dx = dx
    cfg.eta_density = eta
    cfg.flow_max_iters = max_iters
    cfg.precision = "f32"
    cfg.compute_derived()

    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)
    print(f"grid {grid.shape} N={grid.N_total} eta={eta} dx={dx}", flush=True)

    # inline segment loop (host telemetry per segment)
    import jax
    from pd_mg_pin_corrosion_tpu.solvers import (FLOW_SEGMENT_ITERS,
                                                 _solve_steady_segment)
    from pd_mg_pin_corrosion_tpu.dispatch import ops_for
    ops = ops_for(kit)
    dt0 = jax.jit(ops.compute_dt_ns)(state, kit)
    t0 = time.time()
    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(1.0, kit.jdtype),
             dt0, jnp.asarray(False), jnp.asarray(False))
    seg_end = 0
    while True:
        seg_end = min(seg_end + FLOW_SEGMENT_ITERS, cfg.flow_max_iters)
        carry = _solve_steady_segment(
            carry, jnp.asarray(seg_end, jnp.int32), kit, False)
        st, it, eps, dtc, conv, div = carry
        fluid = st.node_type == FLUID
        vm = float(jnp.max(jnp.where(
            fluid, jnp.linalg.norm(st.vel, axis=-1), 0.0)))
        print(f"  iter {int(it)-1}: eps={float(eps):.3e} v_max={vm:.4e} "
              f"dt={float(dtc):.3e} [{time.time()-t0:.0f}s]", flush=True)
        if bool(conv) or bool(div) or int(it) > cfg.flow_max_iters:
            break
    st, iters, eps, conv, div = st, it, eps, conv, div
    wall = time.time() - t0
    fluid = np.asarray(st.node_type) == FLUID
    vm = np.asarray(jnp.linalg.norm(st.vel, axis=-1))[fluid]
    rho = np.asarray(st.rho)[fluid]
    print(f"done: iters={int(iters)} eps={float(eps):.3e} conv={bool(conv)} "
          f"div={bool(div)} wall={wall:.0f}s", flush=True)
    print(f"v_max={vm.max():.4e} (2*U_in={2*cfg.U_in:.4e})  "
          f"rho=[{rho.min():.1f},{rho.max():.1f}]")


if __name__ == "__main__":
    main()
