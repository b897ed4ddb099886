"""The slab-sequential step: ``tpgsd_torch.sph.bigstep.make_slab_step_fn``
on the dam break made on the card, its capacity clamped into the
two-tier kernels' range as ``entry`` clamps it."""

from . import program


def build(cfg, device):
    from tpgsd_torch.sph import dam_break, make_slab_step_fn

    sc, gr = cfg["scenario"], cfg["grid"]
    db = dam_break(n_side=sc["n_side"], capacity="auto",
                   capacity_headroom=sc["capacity_headroom"], device=device,
                   on_device=True)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    params, n = db.params, db.n
    del db
    if (list(grid.dims), grid.capacity) != (gr["cells"], gr["capacity"]):
        raise RuntimeError("the program's grid %s, K=%d is not the "
                           "configuration's %s, K=%d"
                           % (grid.dims, grid.capacity, gr["cells"],
                              gr["capacity"]))
    step = make_slab_step_fn(grid, params, cfg["n_slabs"],
                             use_kernels="auto", spill="auto",
                             density_mode=cfg["density_mode"], device=device)
    return program(step, n)
