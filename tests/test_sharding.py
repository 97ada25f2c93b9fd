"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates that the coupled step and the implicit GMRES solve compile and
execute under axial-slab domain decomposition, and that sharded results
match single-device results bitwise (same reduction order under SPMD is not
guaranteed, so comparison is to tight tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pd_mg_pin_corrosion_tpu import Config, build_grid, build_kit, initialize_state
from pd_mg_pin_corrosion_tpu.grid import pad_grid_axial
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as ai
from pd_mg_pin_corrosion_tpu.ops.ard import ard_step
from pd_mg_pin_corrosion_tpu.ops.ns import ns_step
from pd_mg_pin_corrosion_tpu.parallel.sharding import (make_mesh, shard_kit,
                                                       shard_state)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def small_cfg():
    cfg = Config()
    cfg.dx = 5.0e-6
    cfg.R_wire = 20.0e-6
    cfg.L_wire = 100.0e-6
    cfg.R_tube = 60.0e-6
    cfg.L_upstream = 60.0e-6
    cfg.L_downstream = 60.0e-6
    cfg.D_grain = 5.0e-11
    cfg.D_gb = 5.0e-9
    cfg.precision = "f64"
    return cfg.compute_derived()


def test_sharded_ns_step_matches_single_device():
    cfg = small_cfg()
    grid = pad_grid_axial(build_grid(cfg), 8)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=jnp.float64)

    ref = jax.jit(lambda s: ns_step(s, kit, 1e-7))(state)

    mesh = make_mesh(8)
    st_sh = shard_state(state, mesh)
    kit_sh = shard_kit(kit, mesh)
    out = jax.jit(lambda s: ns_step(s, kit_sh, 1e-7))(st_sh)

    np.testing.assert_allclose(np.asarray(out.rho), np.asarray(ref.rho),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=1e-12, atol=1e-15)
    # output is actually sharded across 8 devices
    assert len(out.rho.sharding.device_set) == 8


def test_sharded_ard_and_implicit():
    cfg = small_cfg()
    grid = pad_grid_axial(build_grid(cfg), 8)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=jnp.float64)

    ref = jax.jit(lambda s: ard_step(s, kit, 1e-4))(state)
    op_ref = jax.jit(lambda s: ai.assemble(s, kit))(state)
    sol_ref, _ = jax.jit(lambda s, o: ai.implicit_step(s, o, kit, 0.5))(state, op_ref)

    mesh = make_mesh(8)
    st_sh = shard_state(state, mesh)
    kit_sh = shard_kit(kit, mesh)

    out = jax.jit(lambda s: ard_step(s, kit_sh, 1e-4))(st_sh)
    np.testing.assert_allclose(np.asarray(out.C), np.asarray(ref.C),
                               rtol=1e-12, atol=1e-15)

    op = jax.jit(lambda s: ai.assemble(s, kit_sh))(st_sh)
    sol, res = jax.jit(lambda s, o: ai.implicit_step(s, o, kit_sh, 0.5))(st_sh, op)
    assert float(res) < 1e-9
    np.testing.assert_allclose(np.asarray(sol.C), np.asarray(sol_ref.C),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.slow
def test_sharded_coupled_run_matches_single_device(tmp_path):
    """The PRODUCTION path under a mesh (round-3 VERDICT #1): a full
    multi-cycle CoupledSolver.run — repeated steady flow solves, adaptive
    implicit steps, real dissolution/phase change, diagnostics CSV — on
    the 8-device mesh must reproduce the single-device trajectory. Same
    jitted orchestrator, sharded inputs; XLA SPMD partitions every step.

    time_s/floats compared at f64 reduction-roundoff tolerance (SPMD
    reduction order differs from single-device), solid counts exactly."""
    from pd_mg_pin_corrosion_tpu import grains as grains_mod
    from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver

    cfg = small_cfg()
    cfg.R_tube = 80.0e-6
    cfg.c0 = 0.5
    cfg.cfl_factor = 0.25
    cfg.flow_conv_tol = 1.0e-4
    cfg.flow_max_iters = 4000
    cfg.gb_width_cells = 1
    cfg.T_final = 10.0
    cfg.corrosion_steps_per_check = 20
    cfg.use_implicit = 1
    cfg.implicit_output_every = 10**9
    cfg.diagnostic_every = 1
    cfg.compute_derived()

    grid = pad_grid_axial(build_grid(cfg), 8)
    g = grains_mod.generate(grid, cfg)

    def run(out_dir, shard):
        import copy
        c = copy.deepcopy(cfg)
        c.output_dir = str(out_dir)
        kit = build_kit(grid, c)
        state = initialize_state(grid, c, grains=g, dtype=kit.jdtype)
        if shard:
            mesh = make_mesh(8)
            kit = shard_kit(kit, mesh)
            state = shard_state(state, mesh)
        solver = CoupledSolver()
        final = solver.run(grid, state, kit, c)
        rows = np.atleast_1d(np.genfromtxt(f"{c.output_dir}/diagnostics.csv",
                                           delimiter=",", names=True))
        return solver, final, rows

    solver_1, final_1, rows_1 = run(tmp_path / "single", shard=False)
    solver_8, final_8, rows_8 = run(tmp_path / "mesh", shard=True)

    # the run exercised the full production machinery under the mesh
    assert solver_1.total_dissolved > 0
    assert solver_1.flow_solve_count >= 2  # dissolution triggered re-solves
    assert solver_8.total_dissolved == solver_1.total_dissolved
    assert solver_8.total_implicit_steps == solver_1.total_implicit_steps
    assert solver_8.flow_solve_count == solver_1.flow_solve_count

    assert len(rows_8) == len(rows_1)
    np.testing.assert_array_equal(rows_8["solid_nodes"], rows_1["solid_nodes"])
    for col in ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(rows_8[col], rows_1[col],
                                   rtol=1e-9, atol=1e-14, err_msg=col)

    np.testing.assert_array_equal(np.asarray(final_8.node_type),
                                  np.asarray(final_1.node_type))
    np.testing.assert_allclose(np.asarray(final_8.C), np.asarray(final_1.C),
                               rtol=1e-9, atol=1e-14)


@pytest.mark.slow
def test_sharded_fused_cycles_matches_single_device(tmp_path):
    """The fused dissolve-and-continue device loop (coupled_fused_cycles)
    under the mesh: whole [flow re-solve -> assemble -> implicit steps ->
    phase change] cycles execute inside ONE sharded lax.while_loop."""
    from pd_mg_pin_corrosion_tpu import grains as grains_mod
    from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver

    cfg = small_cfg()
    cfg.R_tube = 80.0e-6
    cfg.c0 = 0.5
    cfg.cfl_factor = 0.25
    cfg.flow_conv_tol = 1.0e-4
    cfg.flow_max_iters = 4000
    cfg.gb_width_cells = 1
    cfg.T_final = 10.0
    cfg.corrosion_steps_per_check = 20
    cfg.use_implicit = 1
    cfg.implicit_output_every = 10**9
    cfg.diagnostic_every = 1
    cfg.coupled_fused_cycles = 3
    cfg.compute_derived()

    grid = pad_grid_axial(build_grid(cfg), 8)
    g = grains_mod.generate(grid, cfg)

    def run(out_dir, shard):
        import copy
        c = copy.deepcopy(cfg)
        c.output_dir = str(out_dir)
        kit = build_kit(grid, c)
        state = initialize_state(grid, c, grains=g, dtype=kit.jdtype)
        if shard:
            mesh = make_mesh(8)
            kit = shard_kit(kit, mesh)
            state = shard_state(state, mesh)
        solver = CoupledSolver()
        final = solver.run(grid, state, kit, c)
        rows = np.atleast_1d(np.genfromtxt(f"{c.output_dir}/diagnostics.csv",
                                           delimiter=",", names=True))
        return solver, final, rows

    solver_1, final_1, rows_1 = run(tmp_path / "single", shard=False)
    solver_8, final_8, rows_8 = run(tmp_path / "mesh", shard=True)

    assert solver_1.total_dissolved > 0
    assert solver_8.total_dissolved == solver_1.total_dissolved
    assert solver_8.total_implicit_steps == solver_1.total_implicit_steps

    assert len(rows_8) == len(rows_1)
    np.testing.assert_array_equal(rows_8["solid_nodes"], rows_1["solid_nodes"])
    for col in ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(rows_8[col], rows_1[col],
                                   rtol=1e-9, atol=1e-14, err_msg=col)
    np.testing.assert_array_equal(np.asarray(final_8.node_type),
                                  np.asarray(final_1.node_type))


def test_sharded_3d_step_matches_single_device():
    """3D paths under the mesh: scan-over-stencil bond sums (dynamic-slice
    neighbor views) and the one-hot matmul wall mirror, sharded along z."""
    from pd_mg_pin_corrosion_tpu import boundary as bc

    cfg = Config()
    cfg.dim = 3
    cfg.dx = 8.0e-6
    cfg.R_wire = 16.0e-6
    cfg.L_wire = 64.0e-6
    cfg.R_tube = 48.0e-6
    cfg.L_upstream = 32.0e-6
    cfg.L_downstream = 32.0e-6
    cfg.Q_flow = 1.667e-10
    cfg.precision = "f64"
    cfg.compute_derived()

    grid = pad_grid_axial(build_grid(cfg), 8)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=jnp.float64)

    def step(s):
        s = bc.apply_wall_bc(s, kit)
        s = ns_step(s, kit, 1e-8)
        return bc.apply_wall_bc(s, kit)

    ref = jax.jit(step)(state)

    mesh = make_mesh(8)
    state_sh = shard_state(state, mesh)
    kit_sh = shard_kit(kit, mesh)
    out = jax.jit(step)(state_sh)
    # swap kit for the sharded variant too (masks along z)
    def step_sh(s):
        s = bc.apply_wall_bc(s, kit_sh)
        s = ns_step(s, kit_sh, 1e-8)
        return bc.apply_wall_bc(s, kit_sh)
    out2 = jax.jit(step_sh)(state_sh)

    for o in (out, out2):
        np.testing.assert_allclose(np.asarray(o.rho), np.asarray(ref.rho),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(o.vel), np.asarray(ref.vel),
                                   rtol=1e-12, atol=1e-18)
