"""Bytes of one launch of the streaming closest-hit search (B4), the
search of scenes past the crossover, by its contract: the same as the
resident search's (``roofline/closest_hit.py``); the scene's geometry is
read once however many blocks stream it.
"""

KERNELS = ("blocked_hit_kernel",)
PROBE = ("ray_tracer_tpu_torch.ops.blocked_hit", "nearest_hit_blocked")


def live(scene, o, d, t_min=1e-4, alive=None, *rest, **kw):
    """Live lanes of one launch (a device tensor where there are flags)."""
    return o.shape[0] if alive is None else alive.sum()


def launch_bytes(context: dict, live_lanes: float) -> float:
    lanes = context["lanes"]
    row = 40 if context["textured"] else 26
    return (lanes * (1 + 4 + 4 + 4 * row) + live_lanes * 6 * 4
            + context["num_tris"] * 9 * 4 + context["num_spheres"] * 4 * 4)
