"""The benchmark's own tests: the harness end to end on the CPU at a
small size (the plain pair passes), its checks against broken timed
paths and against the control, the work counts, the GSD reader and the
file ``BENCHMARK.json``.

    python -m pytest portbench/tests -q

Tests marked ``cuda`` drive the command on the card and skip here.
"""

import copy
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, gsd_read, harness
from portbench.reference import sph_summation as ref

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345  # seeds past 32 signed bits must work


def tiny(cfg, n_side=8):
    """``cfg`` at ``n_side``: the dam break's own derivation of the
    lattice, grid and constants (``tpgsd_torch.sph.dam_break``)."""
    box, fill, lz = (2.0, 1.0, 1.0), (0.5, 1.0, 0.8), 0.8
    dx = lz / n_side
    h = 1.3 * dx
    counts_ = [max(1, int(round(box[d] * fill[d] / dx))) for d in range(3)]
    dims = [max(1, int(math.floor(box[d] / (2 * h)))) for d in range(3)]
    c0 = 10 * max(math.sqrt(2 * 9.81 * lz), 1.0)
    cfg = copy.deepcopy(cfg)
    cfg["n"] = counts_[0] * counts_[1] * counts_[2]
    cfg["scenario"].update(n_side=n_side, spacing=dx, lattice=counts_)
    cfg["grid"].update(cells=dims,
                       cell_size=max(box[d] / dims[d] for d in range(3)))
    cfg["physics"].update(mass=1000 * dx ** 3, h=h, dt=0.25 * h / c0, c0=c0)
    # on the CPU the step resolves to the plain passes, which launch none
    cfg["resolved"] = dict(cfg["resolved"], use_kernels=False, spill=False)
    cfg["launches_per_step"] = {}
    return cfg


def small_cell(name, every=4):
    cell = harness.load_cell(name, REPO)
    cell = cell._replace(cfg=tiny(cell.cfg))
    if cell.traffic.get("dump_every"):
        cell = cell._replace(traffic=dict(cell.traffic, dump_every=every))
    return cell


def run(cell, trace=False, seconds=0.2, **kw):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu",
                            time.perf_counter(), log=lambda s: None, **kw)


@pytest.mark.parametrize("name,trace", itertools.product(
    ["dambreak-1M.silent", "dambreak-1M.dump32"], [False, True]))
def test_harness_runs_end_to_end_on_cpu(name, trace):
    cell = small_cell(name)
    result, checks = run(cell, trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2 * cell.cfg["n"]
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert line["metrics"] and set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert 0 < len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert {"ms_per_step", "setup_s"} <= set(line["metrics"])
    assert [c[0] for c in checks] == list(line["checks"])


def test_run_without_a_card_exits_with_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
         "dambreak-1M.silent", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpgsd_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "tpgsd", "tpgsd.sph", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == ["flax", "jax", "jaxlib", "tpgsd"]


def unchanged(step):
    return lambda state: (state, step(state)[1])


def half_left_out(step):
    def broken(state):
        new, aux = step(state)
        n = state.x.shape[0] // 2
        x = torch.cat([new.x[:n], state.x[n:]])
        v = torch.cat([new.v[:n], state.v[n:]])
        return new._replace(x=x, v=v), aux
    return broken


def one_answer_altered(step):
    def broken(state):  # one particle keeps its velocity
        new, aux = step(state)
        v = new.v.clone()
        v[len(v) // 3] = state.v[len(v) // 3]
        return new._replace(v=v), aux
    return broken


def density_altered(step):
    def broken(state):
        new, aux = step(state)
        rho = aux[0].clone()
        rho[len(rho) // 5] *= 1.001
        return new, (rho,) + tuple(aux[1:])
    return broken


class FrameAltered:
    def __init__(self, inner, drop=False, which=3):
        self.inner, self.drop, self.which, self.n = inner, drop, which, 0

    def write_frame(self, chunks, step=None):
        self.n += 1
        if self.n == self.which:  # a frame of the window
            if self.drop:
                return
            chunks = dict(chunks)
            x = np.array(chunks["particles/position"])
            x[7, 1] = np.nextafter(x[7, 1], np.float32(2))
            chunks["particles/position"] = x
        self.inner.write_frame(chunks, step=step)

    def flush(self):
        self.inner.flush()

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("name,fault", [
    ("dambreak-1M.silent", {"step": unchanged}),
    ("dambreak-1M.silent", {"step": half_left_out}),
    ("dambreak-1M.silent", {"step": one_answer_altered}),
    ("dambreak-1M.silent", {"step": density_altered}),
    ("dambreak-1M.dump32", {"writer": FrameAltered}),
    ("dambreak-1M.dump32", {"writer": lambda w: FrameAltered(w, drop=True)}),
    ("dambreak-1M.dump32", {"writer": lambda w: FrameAltered(w, which=7)}),
], ids=["unchanged", "half", "answer", "density", "frame", "frame_lost",
        "frame_inside"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = small_cell(name, every=1)
    result, _ = run(cell, fault=fault, seconds=1.0)
    assert result["correct"] is False and result["failed"] > 0
    if "writer" in fault:  # the faulty frame is neither the first nor last
        assert result["attempted"] - 2 * cell.cfg["n"] > 8


def control_step(cfg):
    """The control put in the program's place: the reference's step of
    every particle in bfloat16, returned as the program's float32."""
    params = ref.Params(cfg)

    def wrap(step):
        def control(state):
            rows = torch.arange(state.x.shape[0])
            out = ref.step_rows(state.x, state.v, rows, params,
                                torch.bfloat16)
            new = state._replace(x=out["x"].float(), v=out["v"].float())
            return new, (out["rho"].float(), out["p"].float(),
                         torch.zeros((), dtype=torch.int32))
        return control
    return wrap


def test_the_control_is_not_correct():
    cell = small_cell("dambreak-1M.silent")
    result, checks = run(cell, control=True)
    assert result["correct"] is True
    limits = cell.cfg["limits"]
    for step in ("first", "last"):
        over = [k for k, v in result["control"][step].items()
                if v > limits[k]]
        assert over, result["control"]
    # and judged through ``correct``, in the program's place
    result, _ = run(cell, fault={"step": control_step(cell.cfg)})
    assert result["correct"] is False and result["failed"] > 0


def test_policy_launches_and_reference_come_from_the_configuration():
    cell = small_cell("dambreak-1M.silent")
    card = dict(cell.cfg, resolved=dict(cell.cfg["resolved"],
                                        use_kernels=True, spill=True))
    with pytest.raises(RuntimeError, match="step resolved to"):
        run(cell._replace(cfg=card))
    launches = dict(cell.cfg, launches_per_step={"density_self": 2})
    with pytest.raises(RuntimeError, match="pair-kernel launches"):
        run(cell._replace(cfg=launches))
    with pytest.raises(ModuleNotFoundError, match="no_such_reference"):
        run(cell._replace(cfg=dict(cell.cfg, reference="no_such_reference")))


def test_bytes_are_counted_for_every_pass_of_the_operations_table():
    assert set(counts.BYTES_PER_PARTICLE) == set(counts.FLOP_PER_PAIR)


def test_frame_sums_agree_across_device_and_file_and_see_one_word():
    from portbench import framesum

    g = torch.Generator().manual_seed(4)
    for n in (5, 800, 3 * 1003):
        t = torch.randn((n, 3), generator=g)
        on_dev = framesum.as_host(framesum.device_sums(t))
        assert framesum.equal(on_dev, framesum.host_sums(t.numpy()))
        for i, j in ((n, n + 1), (0, 3 * n - 1)):
            u = t.clone().reshape(-1)
            u[i], u[j] = t.reshape(-1)[j].item(), t.reshape(-1)[i].item()
            assert not framesum.equal(on_dev, framesum.host_sums(u.numpy()))
        u = t.clone().reshape(-1)
        u[n] = float(np.nextafter(np.float32(u[n].item()), np.float32(9)))
        assert not framesum.equal(on_dev, framesum.host_sums(u.numpy()))


def brute_force_pairs(x, radius):
    d = x[:, None, :].double() - x[None, :, :].double()
    return int(((d * d).sum(-1) < radius * radius).sum())


@pytest.mark.parametrize("n_side", [6, 9])
def test_pair_count_is_the_brute_force_count(n_side):
    from portbench import inputs

    cfg = tiny(harness.load_cell("dambreak-1M.silent", REPO).cfg, n_side)
    x, _ = inputs.lattice(cfg, SEED, "cpu")
    want = brute_force_pairs(x, 2 * cfg["physics"]["h"])
    assert counts.pairs_in_support(x, cfg) == want
    work = counts.work_per_step(x, cfg)
    assert work["flop"] == want * (19 + 38)
    assert work["bytes"] == x.shape[0] * (16 + 44)


def test_reference_step_matches_itself_on_row_subsets():
    from portbench import inputs

    cfg = tiny(harness.load_cell("dambreak-1M.silent", REPO).cfg, 7)
    x, v = inputs.lattice(cfg, SEED, "cpu")
    v = torch.randn(v.shape, generator=torch.Generator().manual_seed(3))
    params = ref.Params(cfg)
    every = torch.arange(x.shape[0])
    full = ref.step_rows(x, v, every, params)
    some = every[::7]
    part = ref.step_rows(x, v, some, params)
    for k in full:
        assert torch.equal(full[k][some], part[k]), k


def test_gsd_reader_reads_the_ports_file_byte_for_byte(tmp_path):
    from tpgsd_torch import fl
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

    rng = np.random.default_rng(5)
    frames = [{"particles/position": rng.random((50, 3), np.float32),
               "particles/density": rng.random(50).astype(np.float32),
               "particles/typeid": rng.integers(0, 4, 50).astype(np.uint32)}
              for _ in range(3)]
    path = str(tmp_path / "t.gsd")
    w = ShardedFrameWriter(path, comm=SingleComm(), static={
        "configuration/box": np.ones(6, np.float32)})
    for i, chunks in enumerate(frames):
        w.write_frame(chunks, step=10 * i)
    w.close()
    with gsd_read.GSDFile(path) as f, fl.open(path, "r") as g:
        assert f.frames == 3 and f.schema == "hoomd"
        for k, chunks in enumerate(frames):
            assert int(f.read(k, "configuration/step")[0]) == 10 * k
            for name, want in chunks.items():
                got = f.read(k, name)
                assert got.tobytes() == want.tobytes()
                assert got.tobytes() == g.read_chunk(k, name).tobytes()
                n, m, dt = f.shape(k, name)
                assert (n, m, dt) == (want.shape[0], (want.shape[1:] or
                                                      (1,))[0], want.dtype)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (REPO / p).is_dir() and not p.startswith("/")
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (REPO / "portbench" / "traffic" /
                (w["traffic"] + ".json")).is_file()
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys, m["name"]
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
            if kind == "end_to_end":
                assert 0 < m["bound"] <= 0.25
                assert m["source"] in ("host_clock", "device_trace")
            else:
                assert (REPO / "portbench" / "metrics" /
                        (m["name"] + ".py")).is_file()
    for name in names:
        assert NAME.match(name), name
    assert len(names) == len(set(names))
    for text in [w["why"] for w in bench["workloads"]] + [
            c["why"] for c in bench["configs"]] + [
            c["source"] for c in bench["configs"]] + [
            m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(tpgsd|jax)", text, re.M), \
            path


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "dambreak-1M.silent", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
