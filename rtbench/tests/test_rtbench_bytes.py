"""The roofline's byte counts on known shapes, and the probes' counts of
live lanes."""

import pytest
import torch

from rtbench import core
from rtbench.trace import HBM_PEAK

TERRAIN_1080P = dict(lanes=1920 * 1080, num_tris=15842, num_spheres=3,
                     rows=128 + 15872, textured=False)
LANES = TERRAIN_1080P["lanes"]


def bytes_of(kernel, live=LANES, **context):
    mod = core.rooflines()[kernel]
    return mod.launch_bytes(dict(TERRAIN_1080P, **context), live)


def test_closest_hit_at_1080p():
    # 137 bytes a live lane, 113 a dead one, 36 a triangle, 16 a sphere
    assert bytes_of("closest_hit") == LANES * 137 + 15842 * 36 + 3 * 16
    assert bytes_of("closest_hit") / HBM_PEAK == pytest.approx(85.0e-6,
                                                               rel=0.01)
    assert (bytes_of("closest_hit") - bytes_of("closest_hit", live=1000)
            == (LANES - 1000) * 24)


def test_textured_rows_are_forty_columns():
    assert (bytes_of("closest_hit", textured=True)
            - bytes_of("closest_hit")) == LANES * 14 * 4


def test_blocked_hit_counts_the_same_contract():
    big = dict(num_tris=190962)
    assert bytes_of("blocked_hit", **big) == bytes_of("closest_hit", **big)
    assert (bytes_of("blocked_hit", live=7, **big)
            == bytes_of("closest_hit", live=7, **big))


def test_scatter_rows_reads_cotangents_of_hits_and_ids_writes_rows():
    assert bytes_of("scatter_rows") == LANES * (26 * 4 + 4) + 16000 * 104
    assert bytes_of("scatter_rows") / HBM_PEAK == pytest.approx(67.3e-6,
                                                                rel=0.01)
    assert (bytes_of("scatter_rows") - bytes_of("scatter_rows", live=0)
            == LANES * 26 * 4)


def test_the_probes_count_live_lanes():
    mods = core.rooflines()
    o = torch.zeros((5, 3))
    alive = torch.tensor([True, False, True, True, False])
    for k in ("closest_hit", "blocked_hit"):
        assert int(mods[k].live(None, o, o, 1e-4, alive)) == 3
        assert int(mods[k].live(None, o, o, alive=alive)) == 3
        assert mods[k].live(None, o, o) == 5
    ids = torch.tensor([0, 7, 3, 8, -1], dtype=torch.int32)
    assert int(mods["scatter_rows"].live(ids, torch.zeros((26, 5)), 8)) == 3
