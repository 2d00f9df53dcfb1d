"""Packings of the scene's planes per viewer frame in the traced stretch
(the port's counter ``scene_planes.packs``)."""


def counters():
    from ray_tracer_tpu_torch.ops.closest_hit import scene_planes
    return {"packs": scene_planes.packs}


def read(trace):
    if not trace.frames:
        return None
    return trace.counts["packs"] / trace.frames
