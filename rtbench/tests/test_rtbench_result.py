"""The result line: the contract's keys, the checks last, and no result
where there is no card."""

import pytest

from rtbench import core
from rtbench.tests.common import CELLS, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contracts_keys(cell, trace):
    r = run_small(cell, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    _, _, _, _, per_layer, end_to_end = core.find_cell(cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) <= {m["name"] for m in per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in end_to_end} - {
            "peak_mem_gib"}          # no allocator on the CPU
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = core.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                    "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "is_available" in out.err


def test_too_few_cards_no_result(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(core.NoCard):
        core.require_cards(1)
