"""Plain references the benchmark judges the program against.

Each module here is plain PyTorch, imports nothing of the program, and
takes nothing the program made: it bins, sums and integrates again from
the inputs and parameters the benchmark hands both sides.  A
configuration names its module under ``reference``; the module gives
``Params(cfg)``, ``step_rows(x, v, rows, params, dtype)``, ``walls``,
and the neighbour search ``Binning`` / ``pairs_within`` that
``counts.py`` counts the pairs with.
"""

import importlib


def load(name):
    """The reference module ``name`` of this package."""
    return importlib.import_module(__name__ + "." + name)
