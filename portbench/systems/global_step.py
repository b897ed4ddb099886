"""The global step: ``tpgsd_torch.entry.entry``, the flagship dam break's
``make_step_fn(..., use_kernels="auto", spill="auto")``."""

from . import program


def build(cfg, device):
    from tpgsd_torch.entry import entry

    step, (state,) = entry(n_side=cfg["scenario"]["n_side"], device=device,
                           density_mode=cfg["density_mode"])
    return program(step, state.x.shape[0])
