"""The 8-bit sRGB encode of ``io/image.to_uint8``: the threshold table
(``io.image.srgb_thresholds``), the kernel that searches it
(``ops/srgb_encode.py``, ``csrc/srgb_encode.cu``) and the routing by the
image's device.

On the CPU: the table's search, done in numpy as the kernel does it,
equals the numpy encode on a stride of float32 bit patterns over [0, 1],
around every threshold and on special values; the kernel's body
(``csrc/srgb_encode.cuh``) compiled as host C++ equals the numpy encode on
images of odd shapes, flipped and not; numpy arrays and CPU tensors keep
the numpy encode and never reach the kernel; the wrapper refuses anything
but a CUDA float32 tensor. On the card (``cuda``): the kernel array-equal
to the numpy encode on random images, on NaN and inf pixels and on a
rendered 800x800 frame of the 15,842-triangle terrain; one launch a viewer
frame, and a returned frame left alone by the next.
This file imports no JAX.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch.io import image
from ray_tracer_tpu_torch.ops import srgb_encode as tse
from ray_tracer_tpu_torch.utils import build
from ray_tracer_tpu_torch.viewer import ViewerCore

from test_torch_hit_record import FOV, LOOK_AT, ORIGIN, RENDER, _terrain

ONE = int(np.float32(1.0).view(np.int32))   # 0x3F800000
SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, -1e-30,
                     -0.5, -3e38, 1.0, 1.0000001, 1.5, 3e38, 1e-45, 1e-38,
                     0.0031308, 0.5], np.float32)
# (H, W, C) images of the host rehearsal and the card's test: odd widths,
# rows of a multiple of 4 values and not, C of 3 and 4, a single row
SHAPES = [(7, 5, 3), (4, 8, 3), (5, 3, 4), (3, 7, 4), (1, 9, 3), (6, 1, 1)]


def levels(x, table):
    """The kernel's encode in numpy: the number of thresholds at or below
    each value, 0 for NaN (which compares false)."""
    x = np.asarray(x, np.float32)
    out = np.searchsorted(table, x, side="right")
    return np.where(np.isnan(x), 0, out).astype(np.uint8)


def numpy_encode(img, flip=True):
    """The numpy encode as ``to_uint8`` ran it before the kernel: flip,
    the sRGB curve, ×255 + 0.5, cast."""
    img = np.asarray(img, np.float32)
    if flip:
        img = img[::-1]
    with np.errstate(invalid="ignore"):   # NaN's cast
        return (image.linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)


def random_image(shape, seed):
    """Values over [-0.25, 1.25] and the table's thresholds with their
    neighbours, in a seeded order."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    t = image.srgb_thresholds().view(np.int32)
    near = (rng.choice(t, n) + rng.integers(-2, 3, n)).astype(np.int32)
    x = np.where(rng.random(n) < 0.5, rng.uniform(-0.25, 1.25, n),
                 near.view(np.float32))
    return x.astype(np.float32).reshape(shape)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_threshold_table_is_ascending_read_only_and_cached():
    t = image.srgb_thresholds()
    assert t.shape == (255,) and t.dtype == np.float32
    assert np.all(np.diff(t) > 0) and 0.0 < t[0] and t[-1] <= 1.0
    assert not t.flags.writeable
    assert image.srgb_thresholds() is t


def test_search_equals_the_numpy_encode_on_a_stride_of_bit_patterns():
    """Every 257th float32 bit pattern in [0, 1] (4,145,344 values) and
    1.0 itself."""
    bits = np.r_[np.arange(0, ONE, 257), ONE].astype(np.int32)
    x = bits.view(np.float32)
    assert len(x) > 4_000_000
    np.testing.assert_array_equal(levels(x, image.srgb_thresholds()),
                                  numpy_encode(x, flip=False))


def test_search_equals_the_numpy_encode_around_every_threshold():
    """±3 ulp around each of the 255 thresholds: the level changes at the
    threshold and nowhere else near it."""
    t = image.srgb_thresholds()
    bits = (t.view(np.int32)[:, None] + np.arange(-3, 4)).astype(np.int32)
    x = bits.view(np.float32)
    got = levels(x, t)
    np.testing.assert_array_equal(got, numpy_encode(x, flip=False))
    k = np.arange(1, 256)
    assert np.all(got[:, 3] == k) and np.all(got[:, 2] == k - 1)


def test_search_equals_the_numpy_encode_on_special_values():
    """NaN, ±inf, −0.0, negatives, values over 1, subnormals and the
    curve's knee."""
    got = levels(SPECIALS, image.srgb_thresholds())
    np.testing.assert_array_equal(got, numpy_encode(SPECIALS, flip=False))
    assert got[0] == 0 and got[2] == 255 and got[3] == 0


@pytest.mark.parametrize("flip", [True, False])
def test_numpy_and_cpu_tensors_keep_the_numpy_encode(flip):
    """``to_uint8`` on numpy arrays and CPU tensors (float32 and float64,
    a non-contiguous view) returns what the numpy encode returns, and no
    kernel launches."""
    img = random_image((9, 11, 3), 0)
    before = tse.srgb_encode.launches
    want = numpy_encode(img, flip)
    for x in (img, torch.from_numpy(img), torch.from_numpy(img).double(),
              torch.from_numpy(np.ascontiguousarray(
                  img.transpose(1, 0, 2))).transpose(0, 1)):
        with np.errstate(invalid="ignore"):
            got = image.to_uint8(x, flip=flip)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert tse.srgb_encode.launches == before


def test_wrapper_refuses_arrays_and_cpu_tensors():
    img = random_image((4, 4, 3), 1)
    before = tse.srgb_encode.launches
    for x in (img, torch.from_numpy(img), torch.from_numpy(img).double()):
        with pytest.raises(ValueError, match="CUDA"):
            tse.srgb_encode(x, True)
    assert tse.srgb_encode.launches == before


HARNESS = r"""
#include <cstdint>
struct alignas(16) float4 { float x, y, z, w; };
#define __device__
#define __forceinline__ inline
#include "srgb_encode.cuh"

// The kernel's work on the host: the padded table, then every group of
// four output bytes in turn, on the kernel's choice of path.
extern "C" void encode(const float* x, unsigned char* out, int rows,
                       int row_len, int flip, const float* thresholds) {
  float table[srgb::kTableWords] = {};
  for (int k = 0; k < srgb::kLevels; ++k)
    table[srgb::slot(k)] = thresholds[k];
  const int n = rows * row_len;
  const bool vec = row_len % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  for (int g = 0; g < (n + 3) / 4; ++g) {
    if (vec)
      srgb::encode_group<true>(x, out, g, n, rows, row_len, flip, table);
    else
      srgb::encode_group<false>(x, out, g, n, rows, row_len, flip, table);
  }
}
"""


@pytest.fixture(scope="module")
def host_encode(tmp_path_factory):
    """The kernel's body built as host C++ with g++ → encode(img, flip,
    offset): ``img`` copied to a 16-byte aligned buffer at ``offset``
    floats, encoded into a buffer with 4 spare bytes that must stay 0xAB."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++) to build the host rehearsal")
    d = tmp_path_factory.mktemp("srgb_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libsrgb_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared",
                    "-fno-strict-aliasing", "-I", str(build.CSRC_DIR),
                    "-o", str(lib), str(d / "harness.cpp")], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.encode.argtypes = [p, p, i, i, i, p]
    table = image.srgb_thresholds()

    def encode(img, flip, offset=0):
        n = img.size
        raw = np.zeros(n + 8, np.float32)
        start = (-raw.ctypes.data // 4) % 4 + offset   # 16-byte aligned
        buf = raw[start:start + n]
        buf[:] = img.ravel()
        out = np.full(n + 4, 0xAB, np.uint8)
        so.encode(buf.ctypes.data, out.ctypes.data, img.shape[0],
                  n // img.shape[0], int(flip), table.ctypes.data)
        assert np.all(out[n:] == 0xAB)
        return out[:n].reshape(img.shape)

    return encode


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("flip", [True, False])
def test_kernel_body_on_the_host_equals_the_numpy_encode(host_encode, shape,
                                                         flip):
    """Both paths of the kernel's body (rows of a multiple of 4 values
    from 16-byte loads, the rest value by value; the input shifted by one
    float takes the second) equal the numpy encode."""
    img = random_image(shape, sum(shape))
    img.ravel()[:len(SPECIALS)] = SPECIALS[:img.size]
    want = numpy_encode(img, flip)
    for offset in (0, 1):
        np.testing.assert_array_equal(host_encode(img, flip, offset), want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(800, 800, 3), (1080, 1920, 3),
                                            (33, 801, 3), (17, 257, 4)])
@pytest.mark.parametrize("flip", [True, False])
def test_kernel_equals_the_numpy_encode_on_cuda(cuda_device, shape, flip):
    """``to_uint8`` of a card tensor: one launch, array-equal to the numpy
    encode of the same values; also from an input one float past a 16-byte
    boundary (the scalar path) and from a float64 tensor."""
    img = random_image(shape, sum(shape) + 7)
    want = numpy_encode(img, flip)
    x = torch.from_numpy(img).to(cuda_device)
    before = tse.srgb_encode.launches
    got = image.to_uint8(x, flip=flip)
    assert tse.srgb_encode.launches == before + 1
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    shifted = torch.empty(img.size + 1, device=cuda_device)[1:]
    shifted.copy_(x.reshape(-1))
    np.testing.assert_array_equal(
        image.to_uint8(shifted.view(shape), flip=flip), want)
    np.testing.assert_array_equal(image.to_uint8(x.double(), flip=flip),
                                  want)


@pytest.mark.cuda
def test_kernel_on_nan_and_inf_pixels_on_cuda(cuda_device):
    img = random_image((64, 96, 3), 3)
    rng = np.random.default_rng(4)
    spots = rng.choice(img.size, 600, replace=False)
    img.ravel()[spots] = rng.choice(SPECIALS, 600)
    got = image.to_uint8(torch.from_numpy(img).to(cuda_device))
    np.testing.assert_array_equal(got, numpy_encode(img))
    assert np.isnan(img).any() and np.isinf(img).any()


def _view_core(device, W=800, H=800):
    cam = rt.Camera(origin=ORIGIN, look_at=LOOK_AT, fov=FOV, aspect=W / H)
    params = rt.RenderParams(width=W, height=H, **RENDER)
    return ViewerCore(_terrain(device), cam, params)


@pytest.mark.cuda
def test_viewer_frames_on_cuda(cuda_device):
    """800x800 frames of the terrain in the viewer: one launch a frame;
    each frame's array equals the numpy encode of its accumulation; an
    array returned by one frame is unchanged after the next."""
    core = _view_core(cuda_device)
    kept = []
    for _ in range(3):
        before = tse.srgb_encode.launches
        rgb, _ = core.frame()
        assert tse.srgb_encode.launches == before + 1
        assert rgb.shape == (800, 800, 3)
        np.testing.assert_array_equal(
            rgb, numpy_encode(core.renderer.image.cpu().numpy()))
        kept.append((rgb, rgb.copy()))
    for rgb, copy in kept:
        np.testing.assert_array_equal(rgb, copy)
    assert len({a.ctypes.data for a, _ in kept}) == len(kept)
