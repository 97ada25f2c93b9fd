"""Backend dispatch: structured (stencil-shift) vs unstructured (gather).

Both backends expose the same function signatures over (state, kit); the
solvers and the coupling orchestrator pick the implementation from the kit
type, so one orchestrator drives uniform and AMR grids alike.
"""

from __future__ import annotations

from types import SimpleNamespace


def is_structured(kit) -> bool:
    from .kit import Kit
    return isinstance(kit, Kit)


def is_block(kit) -> bool:
    """Block-structured AMR kit (amr_blocks.BKit) — stencil-shift speed."""
    from .amr_blocks import BKit
    return isinstance(kit, BKit)


def ops_for(kit) -> SimpleNamespace:
    if is_block(kit):
        from . import amr_blocks as b

        return SimpleNamespace(
            ns_step=b.ns_step,
            compute_dt_ns=b.compute_dt_ns,
            tait_pressure=b.tait_pressure,
            apply_inlet_bc=b.apply_inlet_bc,
            apply_outlet_bc=b.apply_outlet_bc,
            apply_wall_bc=b.apply_wall_bc,
            apply_wall_concentration_bc=b.apply_wall_concentration_bc,
            apply_solid_surface_bc=b.apply_solid_surface_bc,
            smooth_boundary_concentration=b.smooth_boundary_concentration,
            update_fictitious=b.update_fictitious,
            ard_step=b.ard_step,
            ard_compute_dt=b.ard_compute_dt,
            apply_phase_change=b.apply_phase_change,
            assemble=b.assemble,
            implicit_step=b.implicit_step,
            compute_adaptive_dt=b.compute_adaptive_dt,
        )

    if is_structured(kit):
        from . import boundary as bc
        from .ops import ard as ard
        from .ops import ard_implicit as ai
        from .ops import ns as ns

        from .pallas_kernels import ns_step_auto

        return SimpleNamespace(
            ns_step=ns_step_auto,
            compute_dt_ns=ns.compute_dt,
            tait_pressure=ns.tait_pressure,
            apply_inlet_bc=bc.apply_inlet_bc,
            apply_outlet_bc=bc.apply_outlet_bc,
            apply_wall_bc=bc.apply_wall_bc,
            apply_wall_concentration_bc=bc.apply_wall_concentration_bc,
            apply_solid_surface_bc=bc.apply_solid_surface_bc,
            smooth_boundary_concentration=bc.smooth_boundary_concentration,
            update_fictitious=lambda state, kit: state,  # no AMR coupling
            ard_step=ard.ard_step,
            ard_compute_dt=ard.compute_dt,
            apply_phase_change=ard.apply_phase_change,
            assemble=ai.assemble,
            implicit_step=ai.implicit_step,
            compute_adaptive_dt=ai.compute_adaptive_dt,
        )

    from . import unstructured as u

    return SimpleNamespace(
        ns_step=u.ns_step,
        compute_dt_ns=u.compute_dt_ns,
        tait_pressure=u.tait_pressure,
        apply_inlet_bc=u.apply_inlet_bc,
        apply_outlet_bc=u.apply_outlet_bc,
        apply_wall_bc=u.apply_wall_bc,
        apply_wall_concentration_bc=u.apply_wall_concentration_bc,
        apply_solid_surface_bc=u.apply_solid_surface_bc,
        smooth_boundary_concentration=u.smooth_boundary_concentration,
        update_fictitious=u.update_fictitious,
        ard_step=u.ard_step,
        ard_compute_dt=u.ard_compute_dt,
        apply_phase_change=u.apply_phase_change,
        assemble=u.assemble,
        implicit_step=u.implicit_step,
        compute_adaptive_dt=u.compute_adaptive_dt,
    )
