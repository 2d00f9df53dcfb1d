"""Port parity: the scatter-add backward (kernel B2, row-major form B5) and
the winner-row extraction's ``torch.autograd.Function``.

The plain scatter (the CUDA kernel's CPU counterpart) is held to the
reference's Pallas scatters, run in interpret mode on the CPU as the
reference's own tests run them, at rtol 1e-5 / atol 1e-5: both sum f32
values in another order. The Function's backward is held to the autograd
transpose of the table gather it claims to be (rtol 1e-6, atol 1e-6), to
the reference's custom VJP, and ``fused_intersect``'s gradients to the
port's oracle path and to ``jax.grad`` of the reference's fused path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_tpu.ops import intersect as jint
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu_torch.ops import intersect as tint
from ray_tracer_tpu_torch.ops import scatter_rows as tsc

from test_torch_common import probe_rays, scene_pair, t_

SCATTER_TOL = dict(rtol=1e-5, atol=1e-5)


def _ids_and_g(R, n_rows, W, seed, live=None):
    """ids in [0, n_rows] (n_rows = dropped) with duplicates; g (W, R)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_rows + 1, size=R)
    if live is not None:
        ids = np.where(live, rng.integers(0, n_rows, size=R), n_rows)
    g = rng.normal(size=(W, R)).astype(np.float32)
    return ids.astype(np.int32), g


def _numpy_scatter(ids, g_soa, n_rows):
    keep = (ids >= 0) & (ids < n_rows)
    out = np.zeros((n_rows, g_soa.shape[0]), np.float32)
    np.add.at(out, ids[keep], g_soa.T[keep])
    return out


def test_plain_scatter_matches_pallas_both_layouts():
    """700 rays into 300 rows (not a multiple of 128), duplicate and
    dropped ids, against scatter_rows_pallas and scatter_rows_soa_pallas."""
    R, P, W = 700, 300, 26
    ids, g = _ids_and_g(R, P, W, seed=11)
    assert (ids == P).any() and len(np.unique(ids)) < R
    got_rows = tsc.scatter_rows_reference(t_(ids), t_(g.T), P).numpy()
    want_rows = np.asarray(jpk.scatter_rows_pallas(jnp.asarray(ids),
                                                   jnp.asarray(g.T), P))
    np.testing.assert_allclose(got_rows, want_rows, **SCATTER_TOL)
    got_soa = tsc.scatter_rows_soa_reference(t_(ids), t_(g), P).numpy()
    want_soa = np.asarray(jpk.scatter_rows_soa_pallas(jnp.asarray(ids),
                                                      jnp.asarray(g), P))
    np.testing.assert_allclose(got_soa, want_soa, **SCATTER_TOL)
    np.testing.assert_allclose(got_soa, _numpy_scatter(ids, g, P),
                               **SCATTER_TOL)


@pytest.mark.parametrize("live_steps,name", [(2, "sparse"), (30, "dense"),
                                             (0, "all-dead")])
def test_plain_scatter_soa_matches_pallas_wavefronts(live_steps, name):
    """Sparse, dense and all-dead wavefronts (128-ray steps of which
    ``live_steps`` of 32 carry live ids), as the reference's step-list
    test builds them."""
    rng = np.random.default_rng(5 + live_steps)
    R, N, W = 4096, 500, 26
    live = np.zeros(R, bool)
    for s in rng.choice(32, size=live_steps, replace=False):
        live[s * 128:(s + 1) * 128] = rng.random(128) < 0.7
    ids, g = _ids_and_g(R, N, W, seed=live_steps, live=live)
    got = tsc.scatter_rows_soa_reference(t_(ids), t_(g), N).numpy()
    want = np.asarray(jpk.scatter_rows_soa_pallas(
        jnp.asarray(ids), jnp.asarray(g), N,
        cfg=jpk.KConfig(rt=128, step_tiles=1)))
    np.testing.assert_allclose(got, want, err_msg=name, **SCATTER_TOL)
    if not live_steps:
        assert not got.any()


def _equal_id_runs(kind, R, n_rows, seed):
    """(R,) int32 ids in runs of equal ids, where a warp's lanes must be
    summed before the atomic: "one-id" every lane one row; "alternating"
    two rows in turn; "interleaved" runs of 8 equal live ids with the
    dropped ids n_rows and -1 between them; "random" ids in [0, n_rows]."""
    rng = np.random.default_rng(seed)
    lane = np.arange(R)
    if kind == "one-id":
        ids = np.full(R, 7)
    elif kind == "alternating":
        ids = np.where(lane % 2 == 0, 3, n_rows - 1)
    elif kind == "interleaved":
        live = np.repeat(rng.integers(0, n_rows, R // 8 + 1), 8)[:R]
        dropped = np.where(lane % 2 == 0, n_rows, -1)
        ids = np.where(lane % 3 == 2, dropped, live)
    else:
        ids = rng.integers(0, n_rows + 1, size=R)
    return ids.astype(np.int32)


EQUAL_ID_RUNS = ["one-id", "alternating", "interleaved", "random"]


@pytest.mark.parametrize("W", [26, 40])
@pytest.mark.parametrize("kind", EQUAL_ID_RUNS)
def test_plain_scatter_soa_matches_pallas_on_equal_id_runs(kind, W):
    """Runs of equal ids, live and dropped, at the untextured width 26 and
    the textured width 40."""
    R, N = 1000, 300
    ids = _equal_id_runs(kind, R, N, seed=W)
    g = np.random.default_rng(W + 1).normal(size=(W, R)).astype(np.float32)
    got = tsc.scatter_rows_soa_reference(t_(ids), t_(g), N).numpy()
    want = np.asarray(jpk.scatter_rows_soa_pallas(jnp.asarray(ids),
                                                  jnp.asarray(g), N))
    np.testing.assert_allclose(got, want, err_msg=kind, **SCATTER_TOL)
    np.testing.assert_allclose(got, _numpy_scatter(ids, g, N), err_msg=kind,
                               **SCATTER_TOL)
    assert got.shape == (N, W) and got.any()


def test_plain_scatter_of_no_rays_is_zero():
    for fn, g in ((tsc.scatter_rows_soa, torch.zeros((26, 0))),
                  (tsc.scatter_rows, torch.zeros((0, 26)))):
        out = fn(torch.zeros((0,), dtype=torch.int32), g, 300)
        assert out.shape == (300, 26) and not out.any()


def test_wrappers_on_cpu_take_the_plain_version_without_launching():
    ids, g = _ids_and_g(500, 64, 26, seed=2)
    before = (tsc.scatter_rows_soa.launches, tsc.scatter_rows.launches)
    assert torch.equal(tsc.scatter_rows_soa(t_(ids), t_(g), 64),
                       tsc.scatter_rows_soa_reference(t_(ids), t_(g), 64))
    assert torch.equal(tsc.scatter_rows(t_(ids), t_(g.T), 64),
                       tsc.scatter_rows_reference(t_(ids), t_(g.T), 64))
    assert (tsc.scatter_rows_soa.launches, tsc.scatter_rows.launches) == before


def test_wrapper_refuses_devices_without_the_kernel():
    ids = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tsc.scatter_rows_soa(ids, torch.zeros((26, 4), device="meta"), 8)


@pytest.mark.parametrize("ids,g,match", [
    (torch.zeros(4, dtype=torch.int64), torch.zeros((26, 4)), "int32"),
    (torch.zeros(5, dtype=torch.int32), torch.zeros((26, 4)), "int32"),
    (torch.zeros(4, dtype=torch.int32), torch.zeros((26, 4),
                                                    dtype=torch.float64),
     "float32"),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4), "2-D")])
def test_wrapper_refuses_inputs_the_kernel_does_not_take(ids, g, match):
    """Checked on the CPU too, so the tests hold every caller (the
    Function's backward included) to what the kernel takes."""
    with pytest.raises(ValueError, match=match):
        tsc.scatter_rows_soa(ids, g, 8)


# ---------------------------------------------------------------------------
# The winner-row Function
# ---------------------------------------------------------------------------

def _float_leaves(ts):
    return {f.name: getattr(ts, f.name).clone().requires_grad_(True)
            for f in dataclasses.fields(ts)
            if isinstance(getattr(ts, f.name), torch.Tensor)
            and getattr(ts, f.name).is_floating_point()}


def _grads(out, leaves):
    g = torch.autograd.grad(out, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g)}


def test_winner_rows_vjp_is_gather_transpose():
    """The Function's backward (scatter-add, then _pack_attrs' transpose
    by autograd) equals autograd's transpose of the oracle's table gather,
    leaf for leaf, miss-lane cotangents zeroed on both sides; and equals
    the reference's custom VJP of _winner_rows."""
    js, ts, cam = scene_pair("room")
    o, d = probe_rays(cam, 256, seed=8)
    leaves = _float_leaves(ts)
    s = dataclasses.replace(ts, **leaves)
    rows, pid, miss = tint._winner_rows(s, t_(o), t_(d), 1e-4, None)
    assert rows.requires_grad and not pid.requires_grad
    g_rows = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(rows.shape)).astype(np.float32))
    g_rows = torch.where(miss[None], 0.0, g_rows)
    got = _grads((rows * g_rows).sum(), leaves)
    want = _grads((tint._pack_attrs(s)[pid.long()].T * g_rows).sum(), leaves)
    nonzero = 0
    for k in leaves:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        nonzero += bool(got[k].any())
    assert nonzero >= 4

    _, vjp = jax.vjp(lambda sc: jint._winner_rows(
        sc, jnp.asarray(o), jnp.asarray(d), 1e-4, None)[0], js)
    (gj,) = vjp(jnp.asarray(g_rows.numpy()))
    for k in leaves:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(gj, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _hit_loss(h):
    return torch.where(h.hit[:, None], h.albedo + h.normal, 0.0).sum()


@pytest.mark.parametrize("name", ["metal", "room"])
def test_fused_gradients_match_oracle_and_jax(name):
    """fused_intersect (the kernel's plain version forward, the Function's
    scatter backward) against the port's oracle path, every float leaf;
    and its sphere_albedo and tri_v0 gradients against jax.grad of the
    reference's fused path."""
    js, ts, cam = scene_pair(name)
    o, d = probe_rays(cam, 128, seed=6)
    leaves = _float_leaves(ts)
    s = dataclasses.replace(ts, **leaves)
    g_fused = _grads(_hit_loss(tint.fused_intersect(s, t_(o), t_(d), 1e-4,
                                                    None)), leaves)
    g_oracle = _grads(_hit_loss(tint.intersect(s, t_(o), t_(d),
                                               backend="torch")), leaves)
    for k in leaves:
        np.testing.assert_allclose(g_fused[k].numpy(), g_oracle[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    def loss_j(albedo, v0):
        sc = dataclasses.replace(js, sphere_albedo=albedo, tri_v0=v0)
        h = jint.fused_intersect(sc, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                 None)
        return jnp.sum(jnp.where(h.hit[:, None], h.albedo + h.normal, 0.0))

    ga, gv = jax.grad(loss_j, argnums=(0, 1))(js.sphere_albedo, js.tri_v0)
    assert np.abs(np.asarray(ga)).max() > 0
    np.testing.assert_allclose(g_fused["sphere_albedo"].numpy(),
                               np.asarray(ga), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_fused["tri_v0"].numpy(), np.asarray(gv),
                               rtol=1e-4, atol=1e-4)


def test_forward_without_grad_builds_no_table(monkeypatch):
    """With no scene gradient wanted, fused_intersect calls the kernel
    directly: no _pack_attrs and no Function. With one, exactly one of
    each."""
    calls = {"pack": 0, "fn": 0}
    pack, apply = tint._pack_attrs, tint._WinnerRows.apply

    def counting_pack(scene):
        calls["pack"] += 1
        return pack(scene)

    def counting_apply(*args):
        calls["fn"] += 1
        return apply(*args)

    monkeypatch.setattr(tint, "_pack_attrs", counting_pack)
    monkeypatch.setattr(tint._WinnerRows, "apply", counting_apply)
    _, ts, cam = scene_pair("metal")
    o, d = (t_(x) for x in probe_rays(cam, 64, seed=1))
    tint.fused_intersect(ts, o, d, 1e-4, None)
    s = dataclasses.replace(
        ts, sphere_albedo=ts.sphere_albedo.clone().requires_grad_(True))
    with torch.no_grad():
        tint.fused_intersect(s, o, d, 1e-4, None)
    assert calls == {"pack": 0, "fn": 0}
    h = tint.fused_intersect(s, o, d, 1e-4, None)
    assert calls == {"pack": 1, "fn": 1} and h.albedo.requires_grad


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
def test_scatter_kernel_matches_plain_version_on_cuda(cuda_device):
    """Both strides of the kernel against the plain version: duplicates,
    dropped ids, a sparse wavefront, an all-miss one."""
    R, P, W = 70_000, 3_000, 26
    for seed, live in ((0, None), (1, np.random.default_rng(1).random(R)
                                   < 0.05), (2, np.zeros(R, bool))):
        ids, g = _ids_and_g(R, P, W, seed, live)
        ids_c, g_c = t_(ids).to(cuda_device), t_(g).to(cuda_device)
        before = tsc.scatter_rows_soa.launches
        got = tsc.scatter_rows_soa(ids_c, g_c, P)
        assert tsc.scatter_rows_soa.launches == before + 1
        want = tsc.scatter_rows_soa_reference(ids_c, g_c, P)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        got_rows = tsc.scatter_rows(ids_c, g_c.T.contiguous(), P)
        torch.testing.assert_close(got_rows, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_scatter_kernel_sums_equal_id_runs_on_cuda(cuda_device):
    """Both strides of the kernel against the plain version where a warp's
    lanes share ids (all one id, alternating ids, live runs between
    dropped ids, random ids), at widths 26 and 40: every entry within
    1e-5 of the plain value plus 1e-6 of the sum of |g| it adds up (two
    f32 sums of the same n values in different orders differ by up to
    ~n u sum|g|)."""
    R, P = 70_000, 3_000
    for W in (26, 40):
        for kind in EQUAL_ID_RUNS:
            ids = t_(_equal_id_runs(kind, R, P, seed=W)).to(cuda_device)
            g = t_(np.random.default_rng(W).normal(size=(W, R)).astype(
                np.float32)).to(cuda_device)
            want = tsc.scatter_rows_soa_reference(ids, g, P)
            bound = 1e-5 * want.abs() + 1e-6 * tsc.scatter_rows_soa_reference(
                ids, g.abs(), P)
            for got in (tsc.scatter_rows_soa(ids, g, P),
                        tsc.scatter_rows(ids, g.T.contiguous(), P)):
                assert got.shape == (P, W)
                assert bool(((got - want).abs() <= bound).all()), (kind, W)


@pytest.mark.cuda
def test_fused_gradients_on_cuda_match_oracle(cuda_device):
    """The kernels' path (closest hit forward, scatter backward) against
    the oracle path on the same CUDA tensors, every float leaf."""
    _, ts, cam = scene_pair("room")
    o, d = (t_(x).to(cuda_device) for x in probe_rays(cam, 4096, seed=6))
    leaves = {k: v.to(cuda_device).detach().requires_grad_(True)
              for k, v in _float_leaves(ts).items()}
    s = dataclasses.replace(ts.to(cuda_device), **leaves)
    g_fused = _grads(_hit_loss(tint.intersect(s, o, d, backend="cuda")),
                     leaves)
    g_oracle = _grads(_hit_loss(tint.intersect(s, o, d, backend="torch")),
                      leaves)
    for k in leaves:
        torch.testing.assert_close(g_fused[k], g_oracle[k], rtol=1e-4,
                                   atol=1e-5, msg=k)
