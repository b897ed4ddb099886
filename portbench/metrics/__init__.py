"""Per-layer metrics: ``<name>.py`` holds ``read(rec)``, the metric of
one traced stretch (``None`` when there is nothing to read).  Files are
loaded by path, so a metric's name may hold any character a name in
``BENCHMARK.json`` may."""

import importlib.util
from pathlib import Path

_loaded = {}


def load(name):
    """The module of the metric ``name``."""
    if name not in _loaded:
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            Path(__file__).with_name(name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[name] = mod
    return _loaded[name]
