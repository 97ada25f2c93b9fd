"""Sub-cell wall-mirror convergence study (round-2 VERDICT next #4).

The staircase (nearest-node) 3D FNM wall mirror sustains a per-step
velocity limit cycle (~6e-4 at 1M nodes) that keeps the 3D steady-flow
solve from ever meeting flow_conv_tol — production runs fall back to
iteration caps. The sub-cell mirror (wall_mirror_subcell=1, bilinear
weights of the reflected point in the same matmul operator) removes the
leading-order wall error; this script runs the SAME steady solve both
ways and records the eps trajectory + the converged/capped outcome.

Usage: python scripts/study_subcell_mirror.py [dx] [max_iters]
Writes docs/runs/subcell_mirror/REPORT.md
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_one(subcell, dx, max_iters):
    import jax
    import jax.numpy as jnp

    from pd_mg_pin_corrosion_tpu.config import Config
    from pd_mg_pin_corrosion_tpu.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu.fields import initialize_state
    from pd_mg_pin_corrosion_tpu.grid import FLUID, build_grid
    from pd_mg_pin_corrosion_tpu.kit import build_kit
    from pd_mg_pin_corrosion_tpu.solvers import (FLOW_SEGMENT_ITERS,
                                                 _solve_steady_segment)

    cfg = Config.load("config/params_3d.cfg")
    cfg.dx = dx
    cfg.wall_mirror_subcell = int(subcell)
    cfg.flow_max_iters = max_iters
    cfg.precision = "f32"
    cfg.compute_derived()

    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)
    ops = ops_for(kit)
    dt0 = jax.jit(ops.compute_dt_ns)(state, kit)

    eps_hist = []
    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(1.0, kit.jdtype),
             dt0, jnp.asarray(False), jnp.asarray(False))
    seg_end = 0
    t0 = time.time()
    while True:
        seg_end = min(seg_end + FLOW_SEGMENT_ITERS, max_iters)
        carry = _solve_steady_segment(
            carry, jnp.asarray(seg_end, jnp.int32), kit, False)
        st, it, eps_c, _, conv, div = carry
        it_h, eps_h = int(it) - 1, float(eps_c)
        eps_hist.append((it_h, eps_h))
        print(f"  [{'subcell' if subcell else 'staircase'}] iter {it_h} "
              f"eps={eps_h:.3e} ({time.time() - t0:.0f}s)", flush=True)
        if bool(conv) or bool(div) or int(it) > max_iters:
            break

    fluid = np.asarray(st.node_type) == FLUID
    vmag = np.linalg.norm(np.asarray(st.vel), axis=-1)
    v_max = float(vmag[fluid].max())
    return {
        "subcell": subcell, "N": grid.N_total,
        "converged": bool(conv), "diverged": bool(div),
        "iters": int(it) - 1 if (bool(conv) or bool(div)) else int(it),
        "eps_final": float(eps_c), "v_max": v_max, "eps_hist": eps_hist,
        "tol": cfg.flow_conv_tol,
    }


def main():
    dx = float(sys.argv[1]) if len(sys.argv) > 1 else 8.0e-6
    max_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 60000

    r_stair = run_one(0, dx, max_iters)
    r_sub = run_one(1, dx, max_iters)

    base = "docs/runs/subcell_mirror"
    os.makedirs(base, exist_ok=True)
    lines = [
        "# Sub-cell vs staircase 3D wall mirror: steady-flow convergence",
        "",
        f"params_3d.cfg geometry at dx={dx:g} (N={r_stair['N']}), "
        f"flow_conv_tol={r_stair['tol']:g}, cap {max_iters} iters.",
        "",
        "| mirror | converged by tol | iters | final eps | v_max |",
        "|---|---|---|---|---|",
    ]
    for r in (r_stair, r_sub):
        name = "sub-cell (bilinear)" if r["subcell"] else "staircase (reference)"
        lines.append(
            f"| {name} | {'YES' if r['converged'] else 'no (capped)'} | "
            f"{r['iters']} | {r['eps_final']:.3e} | {r['v_max']:.4e} |")
    lines += ["", "eps trajectory (iter, eps):", "",
              "staircase: " + " ".join(f"({i},{e:.1e})" for i, e in
                                       r_stair["eps_hist"][-12:]),
              "",
              "sub-cell:  " + " ".join(f"({i},{e:.1e})" for i, e in
                                       r_sub["eps_hist"][-12:]), ""]
    with open(f"{base}/REPORT.md", "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
