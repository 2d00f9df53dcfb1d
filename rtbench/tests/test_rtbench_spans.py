"""The readers of the port's spans (``rtbench/spans.py``): in a traced
run on the CPU, on the kernels' route, each host-time reader of a cell
gives a positive number and each stream reader gives None (no event pair
is timed without a card); a program without the spans gives no counters
and no numbers."""

import sys

import pytest

from rtbench import core, spans
from rtbench.tests.common import CELLS, run_small


@pytest.fixture(autouse=True)
def spans_off():
    """A traced run switches the port's spans on: switch them off after
    each test, so that later tests run as the benchmark's window does."""
    yield
    from ray_tracer_tpu_torch.utils.metrics import tracing
    tracing(False)


def kernels_route_on_cpu(monkeypatch):
    """The kernels' route on the CPU, where their wrappers take the plain
    versions, with the closest-hit query asking for the scene's planes as
    the kernel does: the packings a run makes on the card run here too."""
    from ray_tracer_tpu_torch import renderer
    from ray_tracer_tpu_torch.ops import closest_hit, intersect
    for mod in (renderer, intersect):
        monkeypatch.setattr(mod, "resolve_backend", lambda b, dev: "cuda")
    plain = closest_hit.nearest_hit_attrs_reference

    def from_planes(scene, *args, **kwargs):
        closest_hit.scene_planes(scene)
        return plain(scene, *args, **kwargs)
    monkeypatch.setattr(closest_hit, "nearest_hit_attrs_reference",
                        from_planes)


def span_metrics(cell):
    return [m["name"] for m in core.find_cell(cell)[4]
            if m["source"] == "program_span"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_span_reader_reads_its_cell(cell, monkeypatch):
    names = span_metrics(cell)
    assert names
    kernels_route_on_cpu(monkeypatch)
    got = run_small(cell, trace=True)["metrics"]
    for name in names:
        if "stream_ms" in name:
            assert name not in got, (name, got.get(name))
        else:
            assert got[name]["value"] > 0.0, name
            assert got[name]["unit"] == "ms"


def test_without_the_spans_nothing_is_read(monkeypatch):
    class Stretch:
        counts, frames, steps = {}, 16, 3
    monkeypatch.setitem(sys.modules, "ray_tracer_tpu_torch.utils.metrics",
                        None)
    assert spans.counters() == {}
    for cell in CELLS:
        for name in span_metrics(cell):
            assert core.metric_module(name).read(Stretch()) is None
