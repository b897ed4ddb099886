"""PyTorch/CUDA WCSPH producer (counterpart of ``tpgsd.sph``).

Covers summation and continuity density on the single-tier layout and
on the two-tier spill layout, closed and periodic boxes, with the XSPH
and Akinci surface-tension options and :func:`energy_rate`; the pair
passes of both layouts run as hand-written CUDA kernels on the card
(:mod:`tpgsd_torch.sph.ops`).

The long-run time loop: :func:`make_adaptive_step_fn` (the CFL
controller, ``dt`` a 0-d device tensor) rolled out by
:func:`run_adaptive` without a host sync, in-loop dumps through
:mod:`tpgsd_torch.io_runtime` (``scan_simulate``,
``scan_simulate_adaptive``), :func:`resume` from the last frame of a
trajectory, and ``dam_break(on_device=True)``, the lattice built on the
card.

The slab-sequential step (:func:`make_slab_step_fn`, seeded in
continuity mode by :func:`slab_init_density`) lays out one x-slab at a
time, for particle counts whose global layout would not fit the card;
its frames stream per slab through
:class:`tpgsd_torch.io_runtime.SlabDumpChannel`.

The slab domain decomposition (:func:`make_distributed_step_fn`, its
adaptive form :func:`make_adaptive_distributed_step_fn`) steps a state
partitioned by :func:`distribute_state` over the shards of a
:func:`tpgsd_torch.parallel.make_mesh` mesh, with halo exchange and
particle migration; several shards may share one GPU.  One process
drives every shard, or with ``make_mesh(comm=...)`` one process per rank
drives its own (:mod:`tpgsd_torch.parallel.exchange` carries the
messages).  :func:`collect_state` / :func:`collect_aux` gather it back
to the host, :func:`frame_shards` hands a field to the writers and
:func:`resume_distributed` re-slabs a trajectory's last frame.
The 2-D and 3-D block decompositions (:func:`make_distributed2d_step_fn`,
:func:`make_distributed3d_step_fn`, their adaptive forms,
:func:`distribute_state_2d` / :func:`distribute_state_3d`,
:func:`resume_distributed2d` / :func:`resume_distributed3d`) step the
same :class:`DistState` over a :func:`tpgsd_torch.parallel.make_mesh2d`
or :func:`~tpgsd_torch.parallel.make_mesh3d` mesh.
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
from .bigstep import make_slab_step_fn, slab_init_density
from .checkpoint import (
    resume,
    resume_distributed,
    resume_distributed2d,
    resume_distributed3d,
)
from .dam_break import DamBreak, dam_break
from .distributed import (
    CollectedState,
    DistAux,
    DistState,
    collect_aux,
    collect_state,
    distribute_state,
    frame_shards,
    make_adaptive_distributed_step_fn,
    make_distributed_step_fn,
)
from .distributed2d import (
    distribute_state_2d,
    make_adaptive_distributed2d_step_fn,
    make_distributed2d_step_fn,
)
from .distributed3d import (
    distribute_state_3d,
    make_adaptive_distributed3d_step_fn,
    make_distributed3d_step_fn,
)
from .kernels import CubicSpline, WendlandC2
from .scenarios import (
    Scenario,
    dam_break_2d,
    hydrostatic_tank,
    still_box,
    still_box_2d,
    taylor_green,
)
from .step import (
    SPHParams,
    SPHState,
    density_and_pressure,
    energy_rate,
    init_density,
    make_adaptive_step_fn,
    make_step_fn,
    run_adaptive,
    tait_pressure,
)

__all__ = [
    "CellGrid",
    "CollectedState",
    "CubicSpline",
    "DamBreak",
    "DistAux",
    "DistState",
    "SPHParams",
    "SPHState",
    "Scenario",
    "WendlandC2",
    "auto_capacity",
    "build_cells",
    "build_cells_spill",
    "collect_aux",
    "collect_state",
    "frame_shards",
    "dam_break",
    "dam_break_2d",
    "density_and_pressure",
    "distribute_state",
    "distribute_state_2d",
    "distribute_state_3d",
    "energy_rate",
    "gather_from_cells",
    "hydrostatic_tank",
    "init_density",
    "make_adaptive_distributed2d_step_fn",
    "make_adaptive_distributed3d_step_fn",
    "make_adaptive_distributed_step_fn",
    "make_adaptive_step_fn",
    "make_distributed2d_step_fn",
    "make_distributed3d_step_fn",
    "make_distributed_step_fn",
    "make_grid",
    "make_slab_step_fn",
    "make_step_fn",
    "neighbor_table",
    "resume",
    "resume_distributed",
    "resume_distributed2d",
    "resume_distributed3d",
    "run_adaptive",
    "scatter_to_cells",
    "scatter_to_cells_soa",
    "slab_init_density",
    "still_box",
    "still_box_2d",
    "tait_pressure",
    "taylor_green",
]
