"""Measure the coarse-grid warm start (cfg.flow_warm_start) on the
flagship 1M-node initial steady flow solve.

The initial solve is the single largest flow block of the flagship run
(~6,500 iterations developing the wake from a plain Poiseuille start —
pd_ns.cpp:182-339 semantics at workload-5 scale). The warm start solves
the same geometry at dx*2 first (8x fewer nodes) and interpolates; this
script times BOTH paths end-to-end (coarse solve + interpolation
included in the warm figure) under the production convergence gate and
checks the two converged fields agree.

Usage: python scripts/measure_warm_start.py [config]   (on the GPU, alone)
Default config: config/params_3d.cfg. AMR configs (e.g. params_amr.cfg)
use the block backend, where the initial solve is ~25 % of the run wall.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    # same persistent compile cache as cli.py — without it the big solve
    # graphs recompile from scratch (~minutes each) and poison wall timings
    from pd_mg_pin_corrosion_tpu.utils import setup_compile_cache
    setup_compile_cache()

    from pd_mg_pin_corrosion_tpu.config import Config
    from pd_mg_pin_corrosion_tpu.fields import initialize_state
    from pd_mg_pin_corrosion_tpu.grid import FLUID, build_grid
    from pd_mg_pin_corrosion_tpu.kit import build_kit
    from pd_mg_pin_corrosion_tpu.solvers import coarse_warm_start, solve_steady

    cfg_path = sys.argv[1] if len(sys.argv) > 1 else "config/params_3d.cfg"
    cfg = Config.load(cfg_path)
    cfg.precision = "f32"
    cfg.output_dir = "/tmp/measure_warm"
    cfg.compute_derived()

    # same backend selection as cli.py: AMR configs use the block backend
    if cfg.use_amr and cfg.amr_backend == "structured":
        from pd_mg_pin_corrosion_tpu import amr_blocks as ab

        grid = ab.build_amr_block_grid(cfg)
        kit = ab.build_bkit(grid, cfg)
        state0 = ab.initialize_state_b(grid, cfg, dtype=kit.jdtype)
    else:
        grid = build_grid(cfg)
        kit = build_kit(grid, cfg)
        state0 = initialize_state(grid, cfg, dtype=kit.jdtype)

    def fence(st):
        return float(jnp.sum(st.rho.astype(jnp.float32)))

    # --- cold (reference behavior) ---
    t0 = time.perf_counter()
    st_cold, it_c, eps_c, conv_c, div_c = solve_steady(state0, kit)
    fence(st_cold)
    wall_cold = time.perf_counter() - t0
    print(f"cold: {int(it_c)} iters, eps={float(eps_c):.3e}, "
          f"converged={bool(conv_c)}, wall={wall_cold:.1f} s", flush=True)

    # --- warm (flow_warm_start=2) ---
    cfg.flow_warm_start = 2
    t0 = time.perf_counter()
    st_w, coarse_iters = coarse_warm_start(state0, grid, kit, cfg)
    fence(st_w)
    st_warm, it_w, eps_w, conv_w, div_w = solve_steady(st_w, kit)
    fence(st_warm)
    wall_warm = time.perf_counter() - t0
    print(f"warm: coarse {coarse_iters} iters + fine {int(it_w)} iters, "
          f"eps={float(eps_w):.3e}, converged={bool(conv_w)}, "
          f"wall={wall_warm:.1f} s (incl. coarse solve + interp)", flush=True)

    # --- same answer ---
    fluid = grid.node_type == FLUID
    v_c = np.asarray(st_cold.vel)[fluid]
    v_w = np.asarray(st_warm.vel)[fluid]
    rel = float(np.sqrt(((v_c - v_w) ** 2).sum() / (v_c**2).sum()))
    print(f"field agreement: rel L2 = {rel:.3e}", flush=True)

    ok = bool(conv_c) and bool(conv_w) and not bool(div_w) and rel < 0.05
    print(json.dumps({
        "cold_iters": int(it_c), "cold_wall_s": round(wall_cold, 1),
        "warm_fine_iters": int(it_w), "warm_coarse_iters": int(coarse_iters),
        "warm_wall_s": round(wall_warm, 1),
        "speedup": round(wall_cold / wall_warm, 2),
        "field_rel_l2": rel, "ok": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
