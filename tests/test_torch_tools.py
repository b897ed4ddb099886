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


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1c76b0a5_12_sph_pairs_cu_4a1c967818accel_pairs_kernelILb1ELb1ELi1EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1c76b0a5_12_sph_pairs_cu_4a1c967818accel_pairs_kernelILb1ELb1ELi1EEEvPKfS2_
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 2240 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1c76b0a5_12_sph_pairs_cu_4a1c967820density_pairs_kernelILb0EEEvPKfPKhS2_S4_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1c76b0a5_12_sph_pairs_cu_4a1c967820density_pairs_kernelILb0EEEvPKfPKhS2_S4_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 2240 bytes smem
"""


def test_ptxas_instances_names_each_instance_as_in_the_source():
    """``chip_smoke.phase_registers`` reads the registers and spills of
    every kernel instance from the compiler's ``-Xptxas -v`` output, with
    the template arguments spelled as in the source."""
    cs = _chip_smoke()
    assert cs.ptxas_instances(_PTXAS_LOG) == {
        "accel_pairs_kernel<true, true, 1>": (64, 8),
        "density_pairs_kernel<false>": (40, 0),
    }
    with pytest.raises(AssertionError, match="spilling"):
        cs.phase_registers(_PTXAS_LOG)
