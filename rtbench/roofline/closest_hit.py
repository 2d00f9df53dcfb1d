"""Bytes of one launch of the closest-hit search (B1) by its contract,
whatever implements it.

Every lane of the wavefront (width × height × rays per pixel) reads its
alive flag (1 byte) once and writes its hit distance (float32), the
winner's id (int32) and the winner's row of the merged attribute table
(26 float32, 40 textured) once; a live lane also reads its origin and
direction (6 float32) once, which a dead lane needs no more. The scene's
geometry is read once in its plain form (9 float32 a triangle, centre and
radius a sphere). The traversal's own boxes, and whatever the kernel
reads again, are not counted: a kernel with another hierarchy does the
same contract.

The live lanes come from the probe: ``live`` reads them from the
arguments of the program's entry ``PROBE`` at each launch.
"""

# device kernels of this search: the first counts the launches
KERNELS = ("closest_hit_kernel",)
# (module, function) of the program's entry to the kernel
PROBE = ("ray_tracer_tpu_torch.ops.closest_hit", "nearest_hit_attrs")


def live(scene, o, d, t_min=1e-4, alive=None, *rest, **kw):
    """Live lanes of one launch (a device tensor where there are flags)."""
    return o.shape[0] if alive is None else alive.sum()


def launch_bytes(context: dict, live_lanes: float) -> float:
    lanes = context["lanes"]
    row = 40 if context["textured"] else 26
    return (lanes * (1 + 4 + 4 + 4 * row) + live_lanes * 6 * 4
            + context["num_tris"] * 9 * 4 + context["num_spheres"] * 4 * 4)
