"""The four-card cell ``dambreak-1e8-slab4.silent`` through the harness on
the CPU: its configuration at a small size on four ``cpu`` shards, end to
end with the trace off and on, and its three per-layer metrics.

    python -m pytest portbench/tests -q
"""

import json

import pytest
import torch

from portbench import harness
from portbench.metrics import load as load_metric
from portbench.tests.test_portbench import REPO, run, tiny

CELL = "dambreak-1e8-slab4.silent"
METRICS = ("xchg_copy_ms", "xchg_mb_per_step", "card_busy_pct")


def small_cell(n_side=9):
    """The cell at ``n_side`` (cells (8, 4, 4) at 9: one y plane a
    shard), its K as the module clamps the dam break's, 600 slots a
    shard."""
    from tpgsd_torch.sph import dam_break

    cell = harness.load_cell(CELL, REPO)
    cfg = tiny(cell.cfg, n_side)
    k = dam_break(n_side=n_side, capacity="auto",
                  capacity_headroom=cfg["scenario"]["capacity_headroom"],
                  device="cpu", on_device=True).grid.capacity
    cfg["grid"]["capacity"] = min(max(k, 24), 64)
    cfg["capacity"] = 600
    return cell._replace(cfg=cfg)


def test_the_cell_asks_for_four_cards_and_reads_its_metrics():
    cell = harness.load_cell(CELL, REPO)
    assert cell.chips == 4 and cell.cfg["mesh"]["cards"] == 4
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {
        "ms_per_step", "peak_bytes_per_particle", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_end_to_end_on_four_cpu_shards(trace):
    cell = small_cell()
    result, checks = run(cell, trace)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 2 * cell.cfg["n"]
    assert line["checks"]["dropped"]["value"] == 0
    if not trace:
        assert set(line["metrics"]) == {"ms_per_step", "setup_s"}
        return
    # no peer copy on the CPU: the copy metric has nothing to read
    assert set(line["metrics"]) == {"xchg_mb_per_step", "card_busy_pct"}
    assert 0 < line["metrics"]["card_busy_pct"]["value"] <= 100
    assert line["metrics"]["xchg_mb_per_step"]["value"] > 0


def test_the_metrics_read_a_record_of_four_cards(monkeypatch):
    from portbench.systems import mesh_step

    monkeypatch.setattr(mesh_step, "devices_in_use",
                        [torch.device("cuda", d) for d in range(4)])
    # four cards, each busy 60 of the region's 100 us, 10 of them in
    # peer copies, over two steps
    ops = []
    for d in range(4):
        ops += [("kernel", 0.0, 50.0), ("Memcpy PtoP (Device -> Device)",
                                        50.0, 60.0)]
    rec = {"ops": ops, "start": 0.0, "end": 100.0, "steps": 2}
    assert load_metric("card_busy_pct").read(rec) == pytest.approx(60.0)
    assert load_metric("xchg_copy_ms").read(rec) == pytest.approx(0.02)
    rec["ops"] = [("kernel", 0.0, 50.0)]
    assert load_metric("xchg_copy_ms").read(rec) is None

    from tpgsd_torch.parallel import exchange

    monkeypatch.setattr(exchange, "stats", {"local_bytes": 3_000_000,
                                            "bytes": 1_000_000, "steps": 2})
    assert load_metric("xchg_mb_per_step").read(rec) == pytest.approx(2.0)
    # a program without the counters reads nothing, and does not raise
    monkeypatch.setattr(exchange, "stats", {"bytes": 0, "messages": 0})
    assert load_metric("xchg_mb_per_step").read(rec) is None
