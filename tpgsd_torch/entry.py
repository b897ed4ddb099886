"""The flagship step of the port (counterpart of ``__graft_entry__.entry``).

The WCSPH step on the dam-break workload with the two-tier spill layout,
its main tier sized at 1.15x the densest initial cell, in summation or
continuity density mode.  On a CUDA device the ``"auto"`` policies
resolve to the hand-written pair kernels; on the CPU to the plain pair
passes.
"""

from .sph import dam_break, init_density, make_step_fn


def entry(n_side=8, device="cuda", density_mode="summation"):
    """Step function on the flagship configuration + example args.

    Args:
        n_side: particles along the fluid block's z edge (86 gives the
            1,003,104-particle dam break, 40 the 100,000-particle one).
        device: where the state lives and the step runs.
        density_mode: ``"summation"`` or ``"continuity"`` (the state then
            carries ``rho``, seeded with the summation density).

    Returns:
        ``(step, (state,))`` where ``step(state)`` returns ``(state,
        (rho, p, overflow))``.
    """
    db = dam_break(
        n_side=n_side, capacity="auto", capacity_headroom=1.15, device=device
    )
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    step = make_step_fn(
        grid, db.params, use_kernels="auto", spill="auto",
        density_mode=density_mode, device=device,
    )
    state = db.state
    if density_mode == "continuity":
        state = init_density(state, grid, db.params, device=device)
    return step, (state,)
