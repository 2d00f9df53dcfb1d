"""One rank of the port's 2-rank gloo group on the CPU, for
tests/test_torch_parallel.py.

Joins the group through ``distributed.initialize`` with an explicit
coordinator, then runs the cases of ``<inputs>.json`` (scenes carried
across from the reference as numpy leaves in ``<inputs>.npz``): sharded
renders, the mesh loss's and the sharded chunked gradient, and one
training step on the mesh. Writes ``<out_dir>/rank<r>.npz`` and prints
one line of JSON. Imports torch and the port only.

Usage: python tests/_torch_parallel_worker.py <rank> <port> <inputs> <out_dir>
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    inputs, out_dir = sys.argv[3], sys.argv[4]
    sys.path.insert(0, REPO)
    import ray_tracer_tpu_torch as rt
    from ray_tracer_tpu_torch.grad import inverse as inv
    from ray_tracer_tpu_torch.parallel import (distributed, make_mesh,
                                               render_frame_distributed)
    from ray_tracer_tpu_torch.renderer import render_pixels

    ok = distributed.initialize(f"localhost:{port}", 2, rank, device="cpu")
    assert ok, "initialize() returned False with a named coordinator"
    assert distributed.initialize(device="cpu"), "second call not idempotent"

    with open(inputs + ".json") as f:
        spec = json.load(f)
    arrays = np.load(inputs + ".npz")

    def scene(name):
        keys = [k for k in arrays.files if k.startswith(name + "__")]
        return rt.scene_from_numpy({k.split("__", 1)[1]: arrays[k]
                                    for k in keys}, device="cpu")

    def basis(name, params):
        cam = rt.Camera(**spec["cameras"][name])
        return rt.camera_basis(cam.replace(aspect=params.aspect))

    mesh = make_mesh(2)
    out = {}
    hc = distributed.make_host_chip_mesh()
    out["host_chip_shape"] = np.array(hc.shape)
    for case, c in spec["renders"].items():
        params = rt.RenderParams(**c["params"])
        s = scene(c["scene"])
        b = basis(c["scene"], params)
        out[f"render__{case}"] = render_frame_distributed(
            s, b, params, c["frame"], mesh).numpy()
        out[f"render_hc__{case}"] = render_frame_distributed(
            s, b, params, c["frame"], hc).numpy()

    g = spec["grads"]
    params = rt.RenderParams(**g["params"])
    s = scene(g["scene"])
    b = basis(g["scene"], params)
    target = torch.from_numpy(arrays["grad_target"])
    trainable, _ = inv.split_scene(s, tuple(g["fields"]))
    leaves = {k: v.clone().requires_grad_(True) for k, v in trainable.items()}
    loss = inv.image_mse(leaves, s, b, params, g["frame"], target, mesh=mesh)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out["mse_loss"] = loss.detach().numpy()
    for k, gk in zip(leaves, grads):
        out[f"mse__{k}"] = gk.numpy()

    def rp(tr, ids):
        return render_pixels(inv.merge_scene(s, tr), b, params, g["frame"],
                             ids)

    loss, grads = inv.sharded_chunked_mse_value_and_grad(
        trainable, rp, params, target, g["chunks"], mesh)
    out["chunked_loss"] = loss.numpy()
    for k, gk in grads.items():
        out[f"chunked__{k}"] = gk.numpy()

    t = spec["train"]
    params = rt.RenderParams(**t["params"])
    s = scene(t["scene"])
    init_fn, step_fn = inv.make_train_step(
        params, mesh=mesh, grad_chunks=t["grad_chunks"],
        edge_samples=t["edge_samples"])
    tr, opt = init_fn(s)
    tr, opt, loss = step_fn(tr, opt, s, basis(t["scene"], params),
                            torch.zeros((params.height, params.width, 3)), 0)
    out["train_loss"] = loss.numpy()
    for k, v in tr.items():
        out[f"train__{k}"] = v.detach().numpy()

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    print(json.dumps({"rank": rank, "world": torch.distributed.get_world_size(),
                      "ok": True}))


if __name__ == "__main__":
    main()
