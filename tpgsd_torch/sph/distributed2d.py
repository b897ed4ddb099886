"""2-D block decomposition of the SPH step over a ``(px, py)`` mesh
(torch counterpart of ``tpgsd.sph.distributed2d``).

Shard ``(i, j)`` of a :func:`~tpgsd_torch.parallel.make_mesh2d` mesh
(shard ``i * py + j``) owns the ``nxl x nyl x nz`` cell block at block
coordinates ``(i, j)``.  The step is the decomposition engine of
:mod:`tpgsd_torch.sph.distributed` cutting x and y: the halo goes y,
then x of the y-extended block, so the edge and corner cells ride along;
a particle hops x, then y, so a diagonal mover arrives in one step; on a
periodic box x and y wrap through the rings of the mesh's axes and z
locally in the pair passes.  The pair passes run on the block's extended
grid ``(nxl + 2, nyl + 2, nz)``.
"""

from .distributed import _adaptive_step, _decomposed_step, _distribute
from .kernels import WendlandC2


def make_distributed2d_step_fn(
    grid,
    params,
    mesh,
    capacity=None,
    migrate_cap=None,
    kernel=WendlandC2,
    use_kernels="auto",
    n_fixed=0,
    periodic=False,
    compute_energy=False,
    xsph=0.0,
    density_renorm=False,
    surface_tension=0.0,
    spill="auto",
    density_mode="summation",
    delta_sph=0.1,
    _traced_dt=False,
):
    """Build the 2-D block-decomposed step over a ``(px, py)`` mesh.

    Args:
        grid: global :class:`~tpgsd_torch.sph.cells.CellGrid`;
            ``grid.dims[0]`` must be a multiple of ``px`` and
            ``grid.dims[1]`` of ``py``.
        params: :class:`~tpgsd_torch.sph.SPHParams`.
        mesh: a 2-D :class:`~tpgsd_torch.parallel.Mesh`
            (:func:`~tpgsd_torch.parallel.make_mesh2d`); the states the
            step takes lie on its devices, shard ``i * py + j`` (block
            ``(i, j)``) on ``mesh.devices[i * py + j]``.
        capacity: particle slots a shard (required;
            :func:`distribute_state_2d` returns its choice).
        migrate_cap: migrations a face a hop a step (default
            ``capacity // 4``, at least 8).
        use_kernels / spill: as in
            :func:`~tpgsd_torch.sph.distributed.make_distributed_step_fn`,
            resolved on a block's extended grid ``(nxl + 2, nyl + 2,
            nz)``: on CUDA ``"auto"`` runs the kernels, the two-tier spill
            layout up to 64 slots a cell and the single tier past it.
        n_fixed: particles with ``pid < n_fixed`` are static boundary
            particles that never move or migrate.
        periodic: periodic box.  x and y wrap through the rings of the
            mesh's axes (each needs at least 3 cells), z locally in the
            pair passes' ghost halo (the kernels) or wrapped table (the
            plain passes), on at least 3 cells.
        compute_energy / xsph / density_renorm / surface_tension /
            density_mode / delta_sph / kernel: as in the slab step.

    Returns:
        ``step(state, dt=params.dt) -> (DistState, DistAux)``, carrying
        ``resolved = {"use_kernels", "spill", "density_mode"}``; ``dt``
        may be a 0-d float32 device tensor.  The step makes no host
        sync and opens the slab step's ``mesh.*`` ranges.
    """
    return _decomposed_step(
        grid, params, mesh, (0, 1), capacity=capacity,
        migrate_cap=migrate_cap, kernel=kernel, use_kernels=use_kernels,
        n_fixed=n_fixed, periodic=periodic, compute_energy=compute_energy,
        xsph=xsph, density_renorm=density_renorm,
        surface_tension=surface_tension, spill=spill,
        density_mode=density_mode, delta_sph=delta_sph,
        _traced_dt=_traced_dt,
    )


def make_adaptive_distributed2d_step_fn(grid, params, mesh, cfl=0.25,
                                        dt_min=0.0, dt_max=None, **kwargs):
    """CFL-adaptive variant of :func:`make_distributed2d_step_fn`: the
    controller of :func:`~tpgsd_torch.sph.distributed.
    make_adaptive_distributed_step_fn` over the blocks (the maxima meet
    on each process's first shard's device and across processes; no host
    sync with one process).

    Returns:
        ``step(state, dt) -> (DistState, DistAux, dt_next)``; at ``dt ==
        params.dt`` it steps bit for bit as the fixed step.
    """
    return _adaptive_step(
        make_distributed2d_step_fn(grid, params, mesh, _traced_dt=True,
                                   **kwargs),
        params, mesh, cfl, dt_min, dt_max)


def distribute_state_2d(state, grid, mesh, capacity=None):
    """Partition a global state onto a 2-D mesh by block ownership.

    As :func:`~tpgsd_torch.sph.distributed.distribute_state`: shard ``i *
    py + j`` holds the particles of block ``(i, j)`` in original-index
    ``pid`` order, on its device; ``capacity`` defaults to the smallest
    multiple of 8 at least twice the densest block's population, and a
    block past it raises ``ValueError``.

    Returns:
        ``(DistState, capacity)``.
    """
    return _distribute(state, grid, mesh, (0, 1), capacity)
