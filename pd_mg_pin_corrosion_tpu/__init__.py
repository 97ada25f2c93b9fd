"""Peridynamic Mg-pin corrosion framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``alhermann/pd-mg-pin-corrosion`` (C++17/OpenMP), redesigned for an
accelerator:
dense stencil-shift bond kernels instead of CSR neighbor loops, functional
state instead of double buffers, ``lax.while_loop`` steady solves, a
matrix-free GMRES implicit transport solver, device-side phase-change
remasking instead of neighbor-list rebuilds, and ``jax.sharding`` domain
decomposition for multi-device scale-out.
"""

from .config import Config
from .fields import State, initialize_state
from .grid import (FLUID, SOLID_MG, WALL, INLET, OUTLET, OUTSIDE, FICTITIOUS,
                   Grid, build_grid, build_stencil)
from .kit import Kit, build_kit

__version__ = "0.1.0"
