"""One rank of a gloo group on the CPU, for
tests/test_torch_progressive_mesh.py.

Joins the group through ``distributed.initialize`` with an explicit
coordinator, then renders each of ``CASES`` on the built-in metal scene
through ``parallel.progressive.render_progressive_distributed``: a call
from frame 0, then a call continuing its image. Writes
``<out_dir>/rank<r>.npz`` (both images of each case, and the counters)
and prints one line of JSON. Imports torch and the port only.

Usage: python tests/_torch_progressive_worker.py <rank> <world> <port> <out_dir>
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# RenderParams of each case: share tiles split unevenly over the ranks
# (64x40 is 5 tiles of 512), a frame of no whole tiles (48x40 is 3.75),
# a set coherent_tile (48x40 is 15 tiles of 128), chunked frames whose
# last chunk is padded, and raster order with coherent scatter off
CASES = {
    "uneven_tiles": dict(width=64, height=40, coherent_tile=0),
    "not_whole_tiles": dict(width=48, height=40, coherent_tile=0),
    "tile_128": dict(width=48, height=40, coherent_tile=128),
    "chunked": dict(width=64, height=40, coherent_tile=0,
                    chunk_pixels=1024),
    "raster": dict(width=40, height=24, coherent_scatter=False),
}
COMMON = dict(bounces=2, skybox=True, coherent_scatter=True)
# (frames, start frame) of the first call and of the call continuing it
CALLS = ((2, 0), (2, 2))


def case_params(name):
    import ray_tracer_tpu_torch as rt
    return rt.RenderParams(**dict(COMMON, **CASES[name]))


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out_dir = sys.argv[4]
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import ray_tracer_tpu_torch as rt
    from ray_tracer_tpu_torch.parallel import distributed
    from ray_tracer_tpu_torch.parallel.progressive import (
        render_progressive_distributed)

    assert distributed.initialize(f"localhost:{port}", world, rank,
                                  device="cpu")
    scene, cam = rt.builtin_scene("metal", device="cpu")
    out = {}
    for name in CASES:
        params = case_params(name)
        basis = rt.camera_basis(cam.replace(aspect=params.aspect))
        img = None
        for k, (frames, start) in enumerate(CALLS):
            img = render_progressive_distributed(
                scene, basis, params, frames, start_frame=start, image0=img)
            out[f"{name}__{k}"] = img.numpy()
        out[f"{name}__tiles"] = np.array(
            render_progressive_distributed.shard_tiles)
    out["gathers"] = np.array(render_progressive_distributed.gathers)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(json.dumps({"ok": True, "rank": rank, "world": world}))


if __name__ == "__main__":
    main()
