"""How each configuration builds the program's step.

A module here has ``build(cfg, device)`` returning a :class:`Program`;
a configuration names its module under ``system``.
"""

from typing import Callable, NamedTuple


class Program(NamedTuple):
    """The step the window drives and what the harness asks of it."""

    step: Callable  # state -> (state, aux): aux = (rho, p, *overflows)
    state: Callable  # (x, v) -> the program's state
    resolved: dict  # the policy the step resolved to
    launches: Callable  # -> {key: count} since the last reset
    reset_launches: Callable
    n: int  # particles of the configuration as the program built it


def program(step, n):
    """A :class:`Program` of an SPH step of ``tpgsd_torch.sph``."""
    from tpgsd_torch.sph import SPHState, ops

    return Program(
        step=step, state=lambda x, v: SPHState(x=x, v=v),
        resolved=dict(step.resolved),
        launches=lambda: {k: v for k, v in ops.launch_counts.items() if v},
        reset_launches=ops.reset_launch_counts, n=int(n))
