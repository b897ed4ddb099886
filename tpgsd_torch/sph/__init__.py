"""PyTorch/CUDA WCSPH producer (counterpart of ``tpgsd.sph``).

Covers summation and continuity density on the single-tier plain path
and on the two-tier spill layout, whose pair passes run as hand-written
CUDA kernels on the card (:mod:`tpgsd_torch.sph.ops`).
"""

from .cells import (
    CellGrid,
    auto_capacity,
    build_cells,
    build_cells_spill,
    gather_from_cells,
    make_grid,
    neighbor_table,
    scatter_to_cells,
    scatter_to_cells_soa,
)
from .dam_break import DamBreak, dam_break
from .kernels import CubicSpline, WendlandC2
from .step import (
    SPHParams,
    SPHState,
    density_and_pressure,
    init_density,
    make_step_fn,
    tait_pressure,
)

__all__ = [
    "CellGrid",
    "CubicSpline",
    "DamBreak",
    "SPHParams",
    "SPHState",
    "WendlandC2",
    "auto_capacity",
    "build_cells",
    "build_cells_spill",
    "dam_break",
    "density_and_pressure",
    "gather_from_cells",
    "init_density",
    "make_grid",
    "make_step_fn",
    "neighbor_table",
    "scatter_to_cells",
    "scatter_to_cells_soa",
    "tait_pressure",
]
