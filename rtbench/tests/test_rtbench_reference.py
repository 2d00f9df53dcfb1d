"""The plain reference against the port's plain path (``backend="torch"``)
on the CPU at a small size."""

import dataclasses
import json

import numpy as np
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch.camera import CameraController, update_camera
from ray_tracer_tpu_torch.grad.inverse import make_train_step
from ray_tracer_tpu_torch.io.image import to_uint8
from rtbench import scenes
from rtbench.reference import pathtrace as ref
from rtbench.reference import train as ref_train
from rtbench.reference import viewer as ref_viewer
from rtbench.tests.common import ROOT

CONFIG = json.loads((ROOT / "rtbench/configs/terrain16k.json").read_text())
RECIPE = dict(CONFIG["scene"], n=16)
RENDER = CONFIG["render"]
CAM = CONFIG["camera"]


def port(arrays, W, H):
    scene = scenes.port_scene(arrays, "cpu")
    basis = rt.camera_basis(rt.Camera(
        origin=tuple(CAM["origin"]), look_at=tuple(CAM["look_at"]),
        fov=CAM["fov"], aspect=W / H))
    return scene, basis, rt.RenderParams(width=W, height=H, **RENDER)


def test_progressive_frames_equal_the_ports_plain_path():
    torch.set_num_threads(2)
    W, H = 64, 32
    arrays = scenes.make(RECIPE, 7)
    scene, basis, params = port(arrays, W, H)
    img = rt.render_progressive(scene, basis, params, 2)
    img = rt.render_progressive(scene, basis, params, 2, start_frame=2,
                                image0=img)
    px = ref.tile_pixels(W, H, range(W * H // ref.SHARE_TILE))
    per = ref.render_lanes(ref.build_scene(arrays, "cpu"),
                           ref.camera_basis(CAM["origin"], CAM["look_at"],
                                            CAM["fov"], W / H),
                           RENDER, W, H, px, [0, 1, 2, 3])
    want = ref.accumulated(per, [0, 1, 2, 3])
    got = img.reshape(-1, 3)[torch.as_tensor(px)]
    assert float((got - want).abs().max()) <= 1e-6
    assert float(want.std()) > 1e-2


def test_the_reference_orders_and_pads_as_the_port_builds():
    arrays = scenes.make(RECIPE, 3)
    S = ref.build_scene(arrays, "cpu")
    scene = scenes.port_scene(arrays, "cpu")
    assert (S["SP"], S["TP"]) == (scene.padded_spheres, scene.padded_tris)
    assert torch.equal(S["v0"], scene.tri_v0)
    assert torch.equal(S["sph_c"], scene.sphere_center)


def test_closest_hit_equals_brute_force_with_ties_to_the_lowest_id():
    from ray_tracer_tpu_torch.ops.intersect import nearest_hit
    arrays = scenes.make(RECIPE, 5)
    scene = scenes.port_scene(arrays, "cpu")
    S = ref.build_scene(arrays, "cpu")
    g = torch.Generator().manual_seed(0)
    o = torch.rand(3000, 3, generator=g) * 8 - 4
    o[:, 1] = torch.rand(3000, generator=g) * 3
    d = torch.randn(3000, 3, generator=g)
    d[:1000, 0] = 0.0                      # axis-parallel rays
    t_want, id_want = nearest_hit(scene, o, d, 1e-4)
    t_got, id_got = ref.closest_hit(S, o, d, 1e-4, ray_chunk=512,
                                    pair_chunk=700)
    assert torch.equal(t_got, t_want)
    hit = torch.isfinite(t_want)
    assert torch.equal(id_got[hit], id_want[hit].long())
    assert int(hit.sum()) > 300


def test_training_steps_match_the_port():
    torch.set_num_threads(2)
    W, H = 32, 16
    traffic = {"width": W, "height": H, "albedo_start": 0.8,
               "lr_albedo": 1e-2, "lr_geometry": 1e-4}
    arrays = scenes.make(RECIPE, 9)
    scene, basis, params = port(arrays, W, H)
    with torch.no_grad():
        target = rt.render_frame(scene, basis, params, 0)
    start = dataclasses.replace(scene, tri_albedo=scene.tri_albedo * 0.8,
                                sphere_albedo=scene.sphere_albedo * 0.8)

    def adam(leaves):
        return torch.optim.Adam([
            {"params": [leaves[0], leaves[3]], "lr": 1e-2},
            {"params": [leaves[1], leaves[2], *leaves[4:]], "lr": 1e-4}])

    init_fn, step_fn = make_train_step(params, adam)
    tr, opt = init_fn(start)
    p0 = {k: v.detach().clone() for k, v in tr.items()}
    losses = []
    for k in range(3):
        tr, opt, loss = step_fn(tr, opt, start, basis, target, k)
        losses.append(float(loss))
    r_losses, r_first, r_start, r_end = ref_train.train(
        arrays, CONFIG, traffic, "cpu")
    assert np.allclose(losses, r_losses, rtol=1e-5)
    change = {k: tr[k].detach() - p0[k] for k in tr}
    r_change = {k: r_end[k] - r_start[k] for k in r_end}
    assert ref_train.leaf_gaps(change, r_change) < 1e-4


def test_fly_keys_replay_the_viewers_camera():
    cam = rt.Camera(origin=(0.0, 1.5, 6.0), look_at=(0.0, -0.8, 0.0))
    origin, look = cam.origin, cam.look_at
    ctl = CameraController()
    for key, dt in (("w", 0.05), ("a", 0.031), (" ", 0.07), ("z", 0.02),
                    ("d", 0.044), ("s", 0.09)):
        ctl.press({"z": "shift", " ": "space"}.get(key, key))
        cam = update_camera(cam, ctl, dt)
        for a in ("amount_forward", "amount_backward", "amount_left",
                  "amount_right", "amount_up", "amount_down"):
            setattr(ctl, a, 0.0)
        origin, look = ref_viewer.fly(origin, look, key, dt)
        assert origin == cam.origin and look == cam.look_at


def test_display_encode_equals_the_ports():
    img = np.random.default_rng(0).random((8, 6, 3), np.float32) * 1.2
    want = to_uint8(torch.from_numpy(img))
    assert np.array_equal(ref_viewer.to_uint8(img[::-1]), want)
