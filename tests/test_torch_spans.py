"""The port's spans (``utils/metrics.span``): nothing recorded while off,
the render, training and viewer spans with their parents and request
ids, self time, the totals' keys, the ring's bound, and the records on
the clock torch's profiler stamps its events with. The module imports
no JAX: its ``cuda`` test runs on the card."""

import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch.grad import inverse
from ray_tracer_tpu_torch.ops.closest_hit import scene_planes
from ray_tracer_tpu_torch.utils import metrics
from ray_tracer_tpu_torch.utils.metrics import (SPANS, span, span_records,
                                                span_totals, tracing)
from ray_tracer_tpu_torch.viewer import ViewerCore

PARAMS = rt.RenderParams(width=16, height=16, bounces=3, skybox=True)


@pytest.fixture(autouse=True)
def spans_off():
    """Every test leaves the spans off, as the process starts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing(False)
    yield
    tracing(False)
    torch.set_num_threads(n)


def room(device="cpu"):
    scene, cam = rt.builtin_scene("room", aspect=1.0, device=device)
    return scene, rt.camera_basis(cam)


def new_records(before):
    """The records of spans opened after the record ``before``."""
    last = before[-1].seq if before else 0
    return [r for r in span_records() if r.seq > last]


def counts(totals_before):
    after = span_totals()
    return {name: after[f"{name}.count"] - totals_before[f"{name}.count"]
            for name in SPANS}


def test_off_records_nothing():
    scene, basis = room()
    before, records = span_totals(), span_records()
    rt.render_progressive(scene, basis, PARAMS, 2)
    assert span_totals() == before
    assert span_records() == records


def test_a_render_records_its_frames_bounces_and_calls():
    scene, basis = room()
    before, records = span_totals(), span_records()
    tracing(True)
    rt.render_progressive(scene, basis, PARAMS, 2, start_frame=5)
    got = counts(before)
    per_frame = {"render.frame": 1, "render.bounce": 4,
                 "render.intersect": 4, "render.scatter": 4}
    assert got == {n: 2 * per_frame.get(n, 0) for n in SPANS}
    new = new_records(records)
    by_seq = {r.seq: r for r in new}
    parent = {"render.frame": None, "render.bounce": "render.frame",
              "render.intersect": "render.bounce",
              "render.scatter": "render.bounce"}
    for r in new:
        up = by_seq.get(r.parent)
        assert (None if up is None else up.name) == parent[r.name]
        assert r.start_ns <= r.end_ns
        if up is not None:
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
            assert r.request == up.request
    frames = [r for r in new if r.name == "render.frame"]
    assert [r.request for r in frames] == [5, 6]
    for f in frames:
        under = [r for r in new if r.request == f.request]
        assert sorted(r.name for r in under) == sorted(
            n for n, k in per_frame.items() for _ in range(k))


def test_self_time_is_inclusive_less_the_children():
    scene, basis = room()
    records = span_records()
    tracing(True)
    before = span_totals()
    rt.render_progressive(scene, basis, PARAMS, 1)
    after = span_totals()
    new = new_records(records)

    def ms(name, kind):
        key = f"{name}.{kind}"
        return after[key] - before[key]
    # a bounce's children are its intersect and scatter calls
    assert ms("render.bounce", "self_ms") == pytest.approx(
        ms("render.bounce", "host_ms") - ms("render.intersect", "host_ms")
        - ms("render.scatter", "host_ms"), abs=1e-6)
    assert ms("render.frame", "self_ms") == pytest.approx(
        ms("render.frame", "host_ms") - ms("render.bounce", "host_ms"),
        abs=1e-6)
    for leaf in ("render.intersect", "render.scatter"):
        assert ms(leaf, "self_ms") == pytest.approx(ms(leaf, "host_ms"),
                                                    abs=1e-6)
    frame = next(r for r in new if r.name == "render.frame")
    inner = sum(r.end_ns - r.start_ns for r in new
                if r.parent == frame.seq)
    assert ms("render.frame", "self_ms") == pytest.approx(
        (frame.end_ns - frame.start_ns - inner) / 1e6, abs=1e-6)


def test_totals_carry_every_declared_name_from_the_start():
    """In a fresh process no span has run: every declared name is there
    at zero, so a later reading less this one never misses a key."""
    code = ("from ray_tracer_tpu_torch.utils.metrics import SPANS, "
            "span_totals\nt = span_totals()\nprint(len(t), sum(t.values()), "
            "sorted(t) == sorted(f'{n}.{k}' for n, s in SPANS.items() for k "
            "in ('count', 'host_ms', 'self_ms') + (('stream_ms', 'stream_n')"
            " if s else ())))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    streams = sum(SPANS.values())
    assert out == [str(3 * len(SPANS) + 2 * streams), "0.0", "True"]
    assert set(span_totals()) == {f"{n}.{k}" for n, s in SPANS.items()
                                  for k in ("count", "host_ms", "self_ms")
                                  + (("stream_ms", "stream_n") if s else ())}


def test_the_ring_stays_bounded():
    tracing(True)
    for _ in range(metrics.SPAN_RING + 10):
        with span("planes.pack"):
            pass
    kept = span_records()
    assert len(kept) == metrics.SPAN_RING
    assert kept[-1].seq - kept[0].seq == metrics.SPAN_RING - 1


def test_names_are_declared_and_spans_decorate():
    with pytest.raises(KeyError):
        span("render.nothing")

    @span("image.encode")        # decided at each call, not here
    def encode(x):
        return x + 1

    before = span_totals()["image.encode.count"]
    assert encode(1) == 2
    assert span_totals()["image.encode.count"] == before
    tracing(True)
    assert encode(2) == 3
    assert span_totals()["image.encode.count"] == before + 1


def test_records_lie_on_the_profilers_clock():
    """An aten op run inside a span lies within the span's record once
    the profiler's event time is offset by its trace start (to the
    profiler's microsecond)."""
    x = torch.ones(4096)
    tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("image.encode"):
            y = x * 3.0
    assert float(y[0]) == 3.0
    rec = span_records()[-1]
    assert rec.name == "image.encode"
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mul = [e for e in prof.events() if e.name == "aten::mul"]
    assert len(mul) == 1
    start = t0 + round(mul[0].time_range.start * 1000)
    end = t0 + round(mul[0].time_range.end * 1000)
    assert rec.start_ns - 1000 <= start <= end <= rec.end_ns + 1000


def test_a_training_step_splits_forward_backward_and_optimizer():
    scene, basis = room()
    target = torch.zeros(PARAMS.height, PARAMS.width, 3)
    init_fn, step_fn = inverse.make_train_step(PARAMS)
    trainable, opt = init_fn(scene, ("tri_albedo",))
    before, records = span_totals(), span_records()
    tracing(True)
    for _ in range(2):
        trainable, opt, _ = step_fn(trainable, opt, scene, basis, target, 0)
    got = counts(before)
    assert {n: got[n] for n in ("train.step", "train.forward",
                                "train.backward", "train.optimizer",
                                "render.frame")} == {
        "train.step": 2, "train.forward": 2, "train.backward": 2,
        "train.optimizer": 2, "render.frame": 2}
    new = new_records(records)
    steps = [r for r in new if r.name == "train.step"]
    assert [r.request for r in steps] == [1, 2]
    for s in steps:
        kids = sorted((r.start_ns, r.name) for r in new
                      if r.parent == s.seq)
        assert [n for _, n in kids] == ["train.forward", "train.backward",
                                        "train.optimizer"]
    after = span_totals()
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer"):
        # no CUDA here: no event pair is timed
        assert after[f"{name}.stream_n"] == before[f"{name}.stream_n"] == 0
        assert after[f"{name}.stream_ms"] == 0.0


def test_a_viewer_frame_splits_the_copy_and_the_encode():
    scene, cam = rt.builtin_scene("room", aspect=1.0, device="cpu")
    core = ViewerCore(scene, cam, rt.RenderParams(width=16, height=16,
                                                  bounces=1))
    core.frame()
    records = span_records()
    tracing(True)
    for _ in range(2):
        core.frame()
    new = new_records(records)
    frames = [r for r in new if r.name == "viewer.frame"]
    assert [r.request for r in frames] == [2, 3]
    for f in frames:
        kids = sorted((r.start_ns, r.name) for r in new
                      if r.parent == f.seq)
        assert [n for _, n in kids] == ["render.frame", "image.to_host",
                                        "image.encode"]
        # the renderer's frame is served under the viewer's request
        assert {r.request for r in new if r.start_ns >= f.start_ns
                and r.end_ns <= f.end_ns} == {f.request}


def test_a_packing_is_a_span():
    scene, _ = room()
    before = span_totals()
    tracing(True)
    packs = scene_planes.packs
    scene_planes(scene)        # outside a plane scope every query packs
    assert scene_planes.packs == packs + 1
    assert counts(before)["planes.pack"] == 1


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
def test_on_the_card_spans_add_nothing_to_the_device(cuda_device):
    """A span around a closest-hit launch encloses the launch's runtime
    call on the profiler's clock, and a traced render has the same device
    events with the spans on as off: the spans put nothing on the device's
    timeline. The stream spans of a training step time their event
    pairs."""
    from ray_tracer_tpu_torch.ops import closest_hit as tch
    scene, basis = room(cuda_device)
    params = rt.RenderParams(width=128, height=128, bounces=3, skybox=True)
    rt.render_progressive(scene, basis, params, 1)        # builds, warms
    torch.cuda.synchronize()
    names = []
    for on in (False, True, False):
        tracing(on)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rt.render_progressive(scene, basis, params, 2)
            torch.cuda.synchronize()
        names.append(sorted(e.name for e in _device_events(prof)))
    assert names[0] == names[1] == names[2]
    assert any("closest_hit_kernel" in n for n in names[1])

    o = torch.tensor([[0.0, 1.0, 3.0]], device=cuda_device).repeat(4096, 1)
    d = torch.randn(4096, 3, device=cuda_device)
    tch.nearest_hit_attrs(scene, o, d)
    torch.cuda.synchronize()
    tracing(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("render.intersect"):
            tch.nearest_hit_attrs(scene, o, d)
        torch.cuda.synchronize()
    rec = span_records()[-1]
    t0 = prof.profiler.kineto_results.trace_start_ns()

    def ns(us):
        return t0 + round(us * 1000)
    kernel = [e for e in _device_events(prof)
              if "closest_hit_kernel" in e.name]
    assert len(kernel) == 1
    launches = [e for e in prof.events() if "LaunchKernel" in e.name
                and rec.start_ns - 1000 <= ns(e.time_range.start)
                and ns(e.time_range.end) <= rec.end_ns + 1000]
    assert launches
    assert ns(kernel[0].time_range.start) >= rec.start_ns - 1000

    target = torch.zeros(params.height, params.width, 3, device=cuda_device)
    init_fn, step_fn = inverse.make_train_step(params)
    trainable, opt = init_fn(scene, ("tri_albedo",))
    before = span_totals()
    step_fn(trainable, opt, scene, basis, target, 0)
    torch.cuda.synchronize()
    after = span_totals()
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer"):
        assert after[f"{name}.stream_n"] - before[f"{name}.stream_n"] == 1
        assert after[f"{name}.stream_ms"] > before[f"{name}.stream_ms"]
