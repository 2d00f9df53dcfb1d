"""Bytes of one launch of the scatter-add (B2), the winner rows'
backward, by its contract: each lane's id (int32) read once; a lane
whose id names a row (a hit) also reads its row cotangent (26 float32,
40 textured) once, which a dropped lane needs no more; the table's rows
(every sphere and triangle row, float32) written once. The kernel's
float64 scratch is the implementation's, not the contract's.

The live lanes are the hits, counted by the probe at the program's entry
``PROBE`` from each launch's ids.
"""

# the scatter and its float64 → float32 rounding: one launch each
KERNELS = ("scatter_rows_kernel", "narrow_kernel")
PROBE = ("ray_tracer_tpu_torch.ops.scatter_rows", "scatter_rows_soa")


def live(ids, g_soa, n_rows, *rest, **kw):
    """Lanes of one launch whose id names a row of the table."""
    return ((ids >= 0) & (ids < n_rows)).sum()


def launch_bytes(context: dict, live_lanes: float) -> float:
    width = 40 if context["textured"] else 26
    return (context["lanes"] * 4 + live_lanes * width * 4
            + context["rows"] * width * 4)
