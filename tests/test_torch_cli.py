"""The port's command line (``python -m ray_tracer_tpu_torch``): every
subcommand in-process on the CPU under RTT_PLATFORM=cpu at 8-16 pixels a
side, its outputs against the library calls they wrap, and the reference's
test_cli.py cases."""

import json

import numpy as np
import pytest
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch import cli
from ray_tracer_tpu_torch.io.image import to_uint8
from ray_tracer_tpu_torch.io.png import decode_png
from ray_tracer_tpu_torch.renderer import render_aov, render_progressive
from ray_tracer_tpu_torch.utils import checkpoint

from test_torch_common import one_thread  # noqa: F401

SIZE = ["--width", "16", "--height", "16"]

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("RTT_PLATFORM", "cpu")


def metal(width=16, height=16, **kw):
    scene, cam = rt.builtin_scene("metal", aspect=width / height,
                                  device="cpu")
    params = rt.RenderParams(width=width, height=height, skybox=True, **kw)
    return scene, rt.camera_basis(cam.replace(aspect=params.aspect)), params


def test_frames_zero_rejected():
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--frames", "0", "--width", "8", "--height", "8"])
    assert e.value.code == 2


def test_user_errors_exit_2_with_one_line(capsys, tmp_path):
    for argv in (["render", "--scene", "nope"] + SIZE,
                 ["render", "--model", str(tmp_path / "none.obj")] + SIZE,
                 ["render", "--width", "0", "--height", "8"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith("error:"), err


def test_without_a_card_a_command_raises(monkeypatch):
    monkeypatch.delenv("RTT_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="RTT_PLATFORM=cpu"):
        cli.main(["render"] + SIZE)


def test_render_png_is_the_progressive_image(tmp_path):
    out = tmp_path / "m.png"
    cli.main(["render", "--scene", "metal", "--frames", "3", "--skybox",
              "-o", str(out)] + SIZE)
    got = decode_png(out.read_bytes())
    scene, basis, params = metal()
    want = to_uint8(render_progressive(scene, basis, params, 3))
    np.testing.assert_array_equal(got, want)


def test_render_npy_round_trip(tmp_path):
    out = tmp_path / "m.npy"
    cli.main(["render", "--scene", "3", "--width", "8", "--height", "8",
              "--frames", "2", "--backend", "torch", "-o", str(out)])
    img = np.load(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("aov", ["depth", "normal"])
def test_render_aov(tmp_path, aov):
    """The raw AOV as .npy (row 0 at the top, as the writers flip), and a
    viewable PNG through the port's codec."""
    cli.main(["render", "--scene", "metal", "--aov", aov,
              "-o", str(tmp_path / "a.npy")] + SIZE)
    scene, basis, params = metal()
    want = render_aov(scene, basis, params, aov).numpy()[::-1]
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), want)
    cli.main(["render", "--scene", "metal", "--aov", aov,
              "-o", str(tmp_path / "a.png")] + SIZE)
    png = decode_png((tmp_path / "a.png").read_bytes())
    assert png.shape == (16, 16, 3) and png.max() > 0


def test_checkpoint_then_resume_equals_one_render(tmp_path):
    """4 frames written with --checkpoint, then --resume for 4 more: the
    image of an uninterrupted 8-frame render, bit for bit."""
    common = ["render", "--scene", "room", "--skybox"] + SIZE
    ck = str(tmp_path / "c.npz")
    cli.main(common + ["--frames", "4", "--checkpoint", ck,
                       "-o", str(tmp_path / "a.npy")])
    cli.main(common + ["--frames", "4", "--resume", ck,
                       "-o", str(tmp_path / "b.npy")])
    cli.main(common + ["--frames", "8", "-o", str(tmp_path / "c.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "c.npy"))


def test_resilient_writes_a_checkpoint_per_safe_point(tmp_path, monkeypatch):
    """--resilient renders in chunks of 8 frames with the checkpoint
    written after each chunk; the image is the plain batch render's."""
    saved = []
    save = checkpoint.save_renderer
    monkeypatch.setattr(checkpoint, "save_renderer", lambda path, r: (
        saved.append(r.frames), save(path, r)))
    common = ["render", "--scene", "metal", "--skybox", "--frames", "10"]
    ck = str(tmp_path / "r.npz")
    cli.main(common + ["--resilient", "--checkpoint", ck, "-o",
                       str(tmp_path / "r.npy")] + SIZE)
    cli.main(common + ["-o", str(tmp_path / "p.npy")] + SIZE)
    assert saved == [7, 9, 9]    # two safe points, then the final save
    np.testing.assert_array_equal(np.load(tmp_path / "r.npy"),
                                  np.load(tmp_path / "p.npy"))
    assert checkpoint.load_renderer(ck, metal()[0]).frames == 9


def test_adaptive_passes_resilient_on(tmp_path, monkeypatch):
    """--adaptive with --resilient keeps the moments' safe points
    (``render_adaptive(..., resilient=True)``), as the reference's CLI
    does; the image is the one without."""
    from ray_tracer_tpu_torch import renderer
    seen = []
    real = renderer.render_adaptive
    monkeypatch.setattr(renderer, "render_adaptive", lambda *a, **kw: (
        seen.append(kw["resilient"]), real(*a, **kw))[1])
    common = ["render", "--scene", "metal", "--skybox", "--frames", "4",
              "--adaptive", "0.01"] + SIZE
    cli.main(common + ["--resilient", "-o", str(tmp_path / "r.npy")])
    cli.main(common + ["-o", str(tmp_path / "p.npy")])
    assert seen == [True, False]
    np.testing.assert_array_equal(np.load(tmp_path / "r.npy"),
                                  np.load(tmp_path / "p.npy"))


def test_render_model_file(tmp_path):
    """--model loads an OBJ into a studio scene framed by its bounds."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                   "vn 0 0 1\nf 1//1 2//1 3//1\nf 1//1 3//1 4//1\n")
    out = tmp_path / "q.npy"
    cli.main(["render", "--model", str(obj), "--frames", "2", "--skybox",
              "-o", str(out)] + SIZE)
    img = np.load(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.std() > 1e-3


def test_benchmark_prints_its_json_line(capsys):
    cli.main(["benchmark", "--scene", "room", "--frames", "2"] + SIZE)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "rays/s" and line["value"] > 0
    assert line["resolution"] == "16x16" and line["frames"] == 2
    assert line["device"] == "cpu"


def test_invert_prints_recovered(capsys):
    cli.main(["invert", "--scene", "metal", "--skybox", "--bounces", "1",
              "--steps", "3", "--edge-samples", "8", "--width", "8",
              "--height", "8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 3 and np.isfinite(line["final_loss"])
    assert isinstance(line["recovered"], bool)


def test_info_runs(capsys):
    cli.main(["info"])
    info = json.loads(capsys.readouterr().out)
    assert "devices" in info and info["torch"] == torch.__version__
    assert info["default_device"] == "cpu"


def test_view_refuses_a_headless_backend():
    pytest.importorskip("matplotlib").use("Agg", force=True)
    with pytest.raises(RuntimeError, match="headless"):
        cli.main(["view", "--scene", "metal"] + SIZE)
