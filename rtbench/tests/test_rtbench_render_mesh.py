"""The four-card render cell's driver (``drivers/render_mesh.py``) on
CPU ranks through the real launcher (``ranks/small_cell.py``): correct at
its ``SMALL`` size, and not correct with a rank's run shifted by one
share tile or left out; its checked tiles cover every rank's run; and its
per-layer readers on a synthetic trace, None where there is nothing to
read."""

import json
import os
import subprocess
import sys

import pytest

from rtbench import core
from rtbench.tests.common import ROOT

CELL = "terrain190k-render-4chip"
ENTRY = ROOT / "rtbench" / "tests" / "ranks" / "small_cell.py"


def run(trace=0, fault=""):
    out = subprocess.run(
        [sys.executable, str(ENTRY), "--workload", CELL, "--seed",
         str(2 ** 31 + 23), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, MESH_FAULT=fault, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_four_cpu_ranks_read_correct():
    r = run(trace=1)
    assert r["correct"] is True and r["failed"] == 0
    assert r["device"]["count"] == 4 and len(r["device"]["ranks"]) == 4
    assert r["checks"]["bad_pixel_share"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["shift", "drop"])
def test_a_rank_run_at_fault_reads_not_correct(fault):
    r = run(fault=fault)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["bad_pixel_share"]["value"] > 0.01


def test_the_checked_tiles_cover_every_ranks_run():
    from rtbench.drivers import render_mesh
    assert render_mesh.tile_runs(1920 * 1080, 4) == [
        (0, 1013), (1013, 2026), (2026, 3038), (3038, 4050)]
    # 48x40 is 3.75 tiles: the partial one is no checked tile
    assert render_mesh.tile_runs(48 * 40, 2) == [(0, 2), (2, 3)]
    _, _, config, traffic, _, _ = core.find_cell(CELL)
    cell = render_mesh.Cell(config, traffic, 2 ** 31 + 3, "cpu")
    cell.inputs()
    assert len(cell.tiles) == 32 and len(set(cell.tiles)) == 32
    for first, stop in cell.runs:
        assert sum(first <= t < stop for t in cell.tiles) == 8


class Trace:
    """What the readers read of a traced stretch: the driver's per-rank
    readings of the spans by call (``rank_spans``)."""

    def __init__(self, rank_spans=None, **context):
        self.counts, self.device = {}, []
        self.ranks = [{"busy_s": 1.0, "window_s": 2.0}]
        self.context = dict(context, rank_spans=rank_spans or {})


def reader(name):
    return core.metric_module(name)


# two measured calls on four ranks: rank 2 reaches the gather last in the
# first call, rank 0 in the second
SPANS = {"parallel.shard": [[130.0, 120.0, 104.0, 117.0],
                            [128.0, 118.0, 106.0, 114.0]],
         "parallel.gather": [[20.0, 31.0, 0.2, 9.0], [0.3, 8.0, 22.0, 9.5]],
         "parallel.all_gather": [[19.9, 30.9, 0.1, 8.9],
                                 [0.2, 7.9, 21.9, 9.4]]}
UNTIMED = {k: [[None] * 4] * 2 for k in SPANS}     # no card timed a pair


def test_the_gather_stream_reader():
    r = reader("gather_stream_ms_per_call.render_mesh")
    assert r.read(Trace(SPANS)) == pytest.approx((0.2 + 0.3) / 2)
    assert r.read(Trace(UNTIMED)) is None
    assert r.read(Trace()) is None


def test_the_shard_imbalance_reader():
    r = reader("shard_stream_ms.imbalance_pct.render_mesh")
    # ranks' sums 258, 238, 210, 231
    assert r.read(Trace(SPANS)) == pytest.approx(100 * 48 / 258)
    assert r.read(Trace(UNTIMED)) is None
    one = {"parallel.shard": [[130.0], [128.0]]}
    assert r.read(Trace(one)) is None                    # one rank
    assert r.read(Trace()) is None


def test_the_nvlink_reader():
    r = reader("all_gather_stream_ms.nvlink_pct.render_mesh")
    context = {"ranks": 4, "image_lanes": 1920 * 1080, "shard_unit": 512}
    # 1013 tiles a run: three runs of 518,656 lanes of float32 RGB
    assert r.received_bytes(context) == 3 * 518656 * 12
    got = r.read(Trace(SPANS, **context))
    want = 100 * 2 * 3 * 518656 * 12 / 450e9 / ((0.1 + 0.2) * 1e-3)
    assert got == pytest.approx(want)
    assert r.read(Trace(UNTIMED, **context)) is None
    assert r.read(Trace(**context)) is None


def test_one_process_times_each_call_of_every_span(monkeypatch):
    """Without a group the driver's per-rank readings are this process's
    alone, one per measured call; on the CPU no event pair is timed. A
    program without the spans gives none."""
    from rtbench.drivers import render_mesh
    from rtbench.tests.common import small_cell
    cell = small_cell(CELL, 2 ** 31 + 5)
    cell.mark = lambda name: None
    cell.setup()
    got = cell.rank_spans(2)
    assert sorted(got) == sorted(render_mesh.RANK_SPANS)
    assert all(calls == [[None], [None]] for calls in got.values())
    assert cell.calls == 2
    monkeypatch.setitem(sys.modules, "ray_tracer_tpu_torch.utils.metrics",
                        None)
    assert cell.rank_spans(1) == {} and cell.calls == 2
    cell.release()
