"""Port parity of ``utils/metrics.py``: the reference's test cases on the
port, and the stage timer's synchronization with the CUDA device."""

import logging

import pytest
import torch

from ray_tracer_tpu_torch.utils.metrics import FrameClock, StageTimer


def test_frame_clock_stats():
    c = FrameClock(window=8)
    for dt in (0.010, 0.020, 0.030, 0.040):
        c.record(dt)
    assert c.count == 4
    assert abs(c.mean_ms - 25.0) < 1e-6
    assert abs(c.fps - 40.0) < 1e-6
    c.record(0.0)                    # no time measured: not a frame
    assert c.count == 4


def test_frame_clock_window_and_tick():
    c = FrameClock(window=2)
    for dt in (1.0, 2.0, 3.0):
        c.record(dt)
    assert c.count == 2 and abs(c.mean_ms - 2500.0) < 1e-6
    c2 = FrameClock()
    assert c2.mean_ms == 0.0 and c2.fps == 0.0   # no samples: no division


def test_stage_timer_accumulates_and_logs(caplog):
    st = StageTimer()
    with st.stage("a"):
        pass
    with st.stage("a"):
        pass
    with st.stage("b"):
        pass
    rep = st.report()
    assert set(rep) == {"a", "b"} and rep["a"] >= 0.0
    with caplog.at_level(logging.INFO, logger="ray_tracer_tpu_torch.metrics"):
        st.log()
    assert any("stages:" in r.message for r in caplog.records)


def test_stage_timer_exception_still_records():
    st = StageTimer()
    with pytest.raises(ValueError):
        with st.stage("boom"):
            raise ValueError
    assert "boom" in st.report()


@pytest.mark.parametrize("cuda_in_use", [False, True])
def test_stage_waits_for_the_device(monkeypatch, cuda_in_use):
    """Where the process uses CUDA, a stage synchronizes the device when
    it starts and when it ends, so device work queued inside it counts
    and work queued before it does not; on the CPU alone it does not
    touch CUDA."""
    events = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_in_use)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: events.append("sync"))
    st = StageTimer()
    with st.stage("render"):
        events.append("work")
    assert events == (["sync", "work", "sync"] if cuda_in_use else ["work"])
    assert st.report()["render"] >= 0.0
