"""Fused device-side implicit inner loop (implicit_fused_chunk=1) must be
trajectory- and CSV-identical to the reference-style step-at-a-time host
loop (coupling.cpp:174-213 exit semantics, evaluated on device)."""

import numpy as np
import pytest

from tests.test_coupling import coupled_cfg, run_solver

# full coupled-trajectory comparisons, ~2 min each (slow tier)
pytestmark = pytest.mark.slow


def test_fused_chunk_matches_host_loop(tmp_path):
    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    _, _, solver_h, final_h = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.implicit_fused_chunk = 1
    _, _, solver_f, final_f = run_solver(cfg_fused)

    # the run actually exercised the dissolution exit path
    assert solver_h.total_dissolved > 0
    assert solver_f.total_dissolved == solver_h.total_dissolved
    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps

    # CSV trajectories byte-identical (same steps, same dt sequence, same
    # diagnostics at the same cadence)
    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name

    np.testing.assert_array_equal(np.asarray(final_f.C),
                                  np.asarray(final_h.C))
    np.testing.assert_array_equal(np.asarray(final_f.node_type),
                                  np.asarray(final_h.node_type))


def test_coupled_cycles_chunk_matches_host_loop(tmp_path):
    """coupled_fused_cycles (dissolve-and-continue device loop) must be
    trajectory- and CSV-identical to the host-driven cycle loop: same flow
    re-solve cadence/caps, same inner exit conditions, same phase-change
    points. Only flow VTI snapshots inside a chunk are skipped."""
    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    _, _, solver_h, final_h = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.coupled_fused_cycles = 3
    _, _, solver_f, final_f = run_solver(cfg_fused)

    assert solver_h.total_dissolved > 0  # the dissolution path fired
    assert solver_f.total_dissolved == solver_h.total_dissolved
    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps
    assert solver_f.flow_solve_count == solver_h.flow_solve_count

    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name

    # node types (dissolution history) must agree exactly; fields agree to
    # f64 roundoff — compiling the flow segment inside the big chunk lets
    # XLA fuse differently than the standalone host-path executable, so
    # bit-identity across the jit partitioning is not guaranteed
    np.testing.assert_array_equal(np.asarray(final_f.node_type),
                                  np.asarray(final_h.node_type))
    np.testing.assert_allclose(np.asarray(final_f.C),
                               np.asarray(final_h.C), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(final_f.vel),
                               np.asarray(final_h.vel), rtol=0, atol=1e-12)


def test_coupled_cycles_launch_caps_match_host(tmp_path):
    """coupled_launch_steps / coupled_launch_flow_iters bound ONE device
    execution of the fused-cycles chunk (how often the host regains
    control); the host re-launches at cycle boundaries, so the trajectory,
    CSVs, flow-solve cadence and final state must be unchanged."""
    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    _, _, solver_h, final_h = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.coupled_fused_cycles = 4
    cfg_fused.coupled_launch_steps = 3   # << the 20-step cycle budget:
    # forces budget exits mid-chunk so re-launch resumption is exercised
    cfg_fused.coupled_launch_flow_iters = 50
    _, _, solver_f, final_f = run_solver(cfg_fused)

    assert solver_h.total_dissolved > 0
    assert solver_f.total_dissolved == solver_h.total_dissolved
    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps
    assert solver_f.flow_solve_count == solver_h.flow_solve_count

    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name

    np.testing.assert_array_equal(np.asarray(final_f.node_type),
                                  np.asarray(final_h.node_type))
    np.testing.assert_allclose(np.asarray(final_f.C),
                               np.asarray(final_h.C), rtol=0, atol=1e-12)


def test_coupled_cycles_preserves_vti_and_flow_cadence(tmp_path):
    """With per-step VTI output AND a flow snapshot stride enabled, the
    fused-cycles state machine must exit at both I/O boundaries and
    produce the exact snapshot sets (names = frame numbers + times) of the
    host-driven loop — round-3's implementation had to skip per-step VTI
    (and all flow snapshots) entirely when coupled_fused_cycles was on."""
    import os

    def listing(cfg, prefix):
        return sorted(f for f in os.listdir(cfg.output_dir)
                      if f.startswith(prefix) and f.endswith(".vti"))

    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    cfg_host.implicit_output_every = 5
    cfg_host.flow_output_stride = 2
    _, _, solver_h, final_h = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.implicit_output_every = 5
    cfg_fused.flow_output_stride = 2
    cfg_fused.coupled_fused_cycles = 3
    _, _, solver_f, final_f = run_solver(cfg_fused)

    assert solver_h.total_dissolved > 0
    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps
    assert solver_f.flow_solve_count == solver_h.flow_solve_count

    host_corr = listing(cfg_host, "corr_")
    host_flow = listing(cfg_host, "flow_")
    assert host_corr, "cadence must actually produce corr snapshots"
    assert len(host_flow) >= 2, "stride must actually produce flow snapshots"
    assert listing(cfg_fused, "corr_") == host_corr
    assert listing(cfg_fused, "flow_") == host_flow

    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name

    np.testing.assert_array_equal(np.asarray(final_f.node_type),
                                  np.asarray(final_h.node_type))


def test_fused_chunk_preserves_vti_cadence(tmp_path):
    """With per-step VTI output ENABLED, the fused chunk must exit at
    output boundaries and produce the same snapshot files (names = global
    step cadence + times) as the step-at-a-time loop."""
    import os

    def listing(cfg):
        return sorted(f for f in os.listdir(cfg.output_dir)
                      if f.startswith("corr_") and f.endswith(".vti"))

    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    cfg_host.implicit_output_every = 3
    _, _, solver_h, _ = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.implicit_output_every = 3
    cfg_fused.implicit_fused_chunk = 1
    _, _, solver_f, _ = run_solver(cfg_fused)

    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps
    host_vtis = listing(cfg_host)
    fused_vtis = listing(cfg_fused)
    assert host_vtis, "cadence must actually produce snapshots"
    assert fused_vtis == host_vtis

    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name


def test_fused_chunk_launch_cap_matches_host(tmp_path):
    """implicit_fused_chunk=N>1 sets the per-launch step cap;
    mid-window relaunches must not change the trajectory,
    the diagnostics cadence, or the VTI snapshot set."""
    import os

    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    cfg_host.implicit_output_every = 7
    _, _, solver_h, final_h = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.implicit_output_every = 7
    cfg_fused.implicit_fused_chunk = 3  # cap 3 steps/launch (< the
    # 20-step cycle budget AND not a divisor of output_every: exercises
    # cap exits, output-boundary exits, and their interleaving)
    _, _, solver_f, final_f = run_solver(cfg_fused)

    assert solver_h.total_dissolved > 0
    assert solver_f.total_dissolved == solver_h.total_dissolved
    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps

    def listing(cfg):
        return sorted(f for f in os.listdir(cfg.output_dir)
                      if f.startswith("corr_") and f.endswith(".vti"))

    assert listing(cfg_fused) == listing(cfg_host)
    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name

    np.testing.assert_array_equal(np.asarray(final_f.node_type),
                                  np.asarray(final_h.node_type))


def test_fused_checkpoint_cadence_fires_under_output_exits(tmp_path):
    """Round-4 regression: fused-branch checkpoints are cycle-boundary-
    only, but with per-step output every launch used to end at an OUTPUT
    boundary (phase != CYCLE_START), so the checkpoint gate never fired —
    observed on the 1M flagship (13 cycles, checkpoint_every=4, zero
    checkpoints; a device hang then cost the whole run). The dynamic
    cycle_cap must force the checkpoint-due launch to end AT the cycle
    boundary, without changing the trajectory."""
    import os

    cfg_host = coupled_cfg(tmp_path / "host", use_implicit=1)
    cfg_host.implicit_output_every = 1  # per-step VTI output
    _, _, solver_h, final_h = run_solver(cfg_host)

    cfg_fused = coupled_cfg(tmp_path / "fused", use_implicit=1)
    cfg_fused.implicit_output_every = 1
    cfg_fused.coupled_fused_cycles = 8
    cfg_fused.checkpoint_every = 2
    _, _, solver_f, final_f = run_solver(cfg_fused)

    # the checkpoint actually fired (pre-fix: never, in this exact setup)
    assert os.path.exists(f"{cfg_fused.output_dir}/checkpoint.npz")

    # and forcing cycle-boundary exits did not perturb the trajectory
    assert solver_h.total_dissolved > 0
    assert solver_f.total_dissolved == solver_h.total_dissolved
    assert solver_f.total_implicit_steps == solver_h.total_implicit_steps

    def listing(cfg):
        return sorted(f for f in os.listdir(cfg.output_dir)
                      if f.startswith("corr_") and f.endswith(".vti"))

    assert listing(cfg_fused) == listing(cfg_host)
    for name in ("diagnostics.csv", "mass_loss.csv"):
        with open(f"{cfg_host.output_dir}/{name}") as f:
            host_rows = f.read()
        with open(f"{cfg_fused.output_dir}/{name}") as f:
            fused_rows = f.read()
        assert fused_rows == host_rows, name

    np.testing.assert_array_equal(np.asarray(final_f.node_type),
                                  np.asarray(final_h.node_type))
