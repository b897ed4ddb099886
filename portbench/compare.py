"""The comparison that decides ``correct``.

A checked step is judged row by row: the program's density at the
step's input positions and its state after the step, against the
reference's float64 step from the same input state.  The numbers
compared are widest gaps over the checked rows:

* ``rho_gap``: ``|rho - rho_ref| / rho0``;
* ``v_gap``: ``|v - v_ref|`` over the root mean square of the
  reference's change of velocity in the step (a state left unchanged
  reads 1 or more);
* ``x_gap``: ``|x - x_ref| / h``.

Where a drifted position lies within ``wall_eps`` of a wall, whether
that component reflects turns on its last bits, and the two answers
differ by its whole velocity: there either outcome of the reference
counts, the nearer one.  Such components are counted and printed.
``dropped`` counts particles the program left out of a step (its cell
overflow), and ``frames_bad`` the frames of the window missing from
the file or not equal bit for bit to the state at their step.
"""

import torch

from . import reference


def row_gaps(got, ref, cfg):
    """``(gaps, per-row gaps, n)`` of one checked step; ``got`` holds the
    program's float32 ``x``, ``v``, ``rho`` of the rows, ``ref`` the
    configuration's reference's ``step_rows``; ``n`` counts the
    components by a wall where the program took the reference's other
    outcome."""
    plain = reference.load(cfg["reference"])
    ph, gr = cfg["physics"], cfg["grid"]
    f64 = torch.float64
    dev = ref["x"].device
    lo = torch.tensor(gr["lo"], dtype=f64, device=dev)
    hi = torch.tensor(gr["hi"], dtype=f64, device=dev)
    xd, vk = ref["x_drift"].to(f64), ref["v_kick"].to(f64)
    eps = float(cfg["wall_eps"])
    near = ((xd - lo).abs() < eps) | ((xd - hi).abs() < eps)
    bounced = (xd < lo) | (xd > hi)
    x_alt, v_alt = plain.walls(xd, vk, plain.Params(cfg), ~bounced)
    gx, gv = got["x"].to(dev, f64), got["v"].to(dev, f64)
    dx, dv = (gx - ref["x"].to(f64)).abs(), (gv - ref["v"].to(f64)).abs()
    dx_alt, dv_alt = (gx - x_alt).abs(), (gv - v_alt).abs()
    other = near & (dx_alt + dv_alt < dx + dv)
    dx = torch.where(other, dx_alt, dx)
    dv = torch.where(other, dv_alt, dv)
    rho = (got["rho"].to(dev, f64) - ref["rho"].to(f64)).abs() / ph["rho0"]
    dv_rms = torch.sqrt(torch.mean(torch.sum(ref["dv"].to(f64) ** 2, -1)))
    rows = {"rho_gap": rho,
            "v_gap": torch.linalg.vector_norm(dv, dim=-1) / dv_rms,
            "x_gap": torch.linalg.vector_norm(dx, dim=-1) / ph["h"]}
    gaps = {}
    for k, t in rows.items():  # a NaN anywhere fails the gap it is in
        gaps[k] = (float("nan") if bool(torch.isnan(t).any())
                   else float(t.max()))
    return gaps, rows, int(other.sum())


def rows_failed(rows, limits):
    """Rows over any limit (a NaN row counts)."""
    bad = None
    for k, t in rows.items():
        over = ~(t <= limits[k])
        bad = over if bad is None else bad | over
    return int(bad.sum())


def wider(a, b):
    """The wider of two gaps; NaN if either is."""
    return a if a != a else b if b != b else max(a, b)


def within(value, limit):
    """A compared number is within its limit (NaN never is)."""
    return value == value and value <= limit
