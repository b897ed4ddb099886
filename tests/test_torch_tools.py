"""``tools/torch_pair_kernel_times.py`` times the port's kernels through
``chip_smoke.py``'s helpers: every name it takes from there must exist,
and without a card it exits non-zero before it times anything."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "torch_pair_kernel_times.py"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tool_names_exist_in_chip_smoke():
    used = {
        node.attr for node in ast.walk(ast.parse(TOOL.read_text()))
        if isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name) and node.value.id == "cs"
    }
    assert {"pair_passes", "roofline", "spill_inputs", "single_tier_inputs",
            "finish_density", "configuration", "step_ms",
            "phase_profile"} <= used
    cs = _chip_smoke()
    assert not [name for name in sorted(used) if not hasattr(cs, name)]


def test_tool_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the tool would time it")
    proc = subprocess.run(
        [sys.executable, str(TOOL)], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
