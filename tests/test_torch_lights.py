"""Port parity: the NEE light table, the glossy lobe pdf and the light
sampler (``ray_tracer_tpu_torch.lights``) against ``ray_tracer_tpu.lights``.

Tolerances: the table's ids, validity flags and ``has_lights`` are exact;
``packed`` and ``cdf`` are held at rtol 1e-6, since the two frameworks may
sum the cumulative power in another order. The sampler's RNG state is
bit-exact. Its chosen light is exact except where u lies within 1e-6 of a
CDF step (a last-bit difference of the CDF may move such a u across it);
its float outputs and the lobe pdf are held at rtol 1e-5 (XLA's CPU
compiler contracts multiply-adds, the port rounds every product), with an
absolute floor, stated at each assertion, where a difference of
near-equal numbers carries its terms' last bits.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_tpu import lights as jl
from ray_tracer_tpu import sampling as js
from ray_tracer_tpu_torch import lights as tl

from test_torch_common import scene_pair, t_

SCENES = ["balls", "random_balls", "room", "metal", "terrain_nee"]


def _u32(x):
    return x.numpy().astype(np.uint32)


@pytest.mark.parametrize("name", SCENES)
def test_light_table_matches_reference(name):
    jsc, tsc, _ = scene_pair(name)
    want = jl.build_light_table(jsc)
    got = tl.build_light_table(tsc)
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.asarray(want.prim_id))
    np.testing.assert_array_equal(got.entry_valid.numpy(),
                                  np.asarray(want.entry_valid))
    assert bool(got.has_lights) == bool(want.has_lights)
    assert got.packed.shape == (tl.MAX_LIGHTS, 20)
    np.testing.assert_allclose(got.packed.numpy(), np.asarray(want.packed),
                               rtol=1e-6)
    np.testing.assert_allclose(got.cdf.numpy(), np.asarray(want.cdf),
                               rtol=1e-6)
    # the slot map: each valid entry's primitive maps to its slot, every
    # other primitive to -1
    slot = got.slot.numpy()
    valid = got.entry_valid.numpy()
    ids = got.prim_id.numpy()
    np.testing.assert_array_equal(slot[ids[valid]], np.flatnonzero(valid))
    assert (slot >= 0).sum() == valid.sum()


def test_light_table_ties_keep_the_lower_id_first():
    """room's two ceiling triangles have equal power and the padding ties
    at zero: the table keeps top_k's order (lower id first)."""
    _, tsc, _ = scene_pair("room")
    table = tl.build_light_table(tsc)
    p = table.packed[:, 0].numpy()
    assert p[0] == p[1] > 0 and (p[2:] == 0).all()
    ids = table.prim_id.numpy()
    assert ids[0] < ids[1] and (np.diff(ids[2:]) > 0).all()


def test_light_table_refuses_ids_beyond_f32():
    big = types.SimpleNamespace(padded_spheres=128, padded_tris=2 ** 24)
    with pytest.raises(ValueError, match="2\\^24"):
        tl.build_light_table(big)


@pytest.mark.parametrize("name", ["room", "balls", "terrain_nee"])
def test_sample_lights_matches_reference(name):
    jsc, tsc, _ = scene_pair(name)
    rng = np.random.default_rng(7)
    n = 10_000
    state = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(
        np.uint32)
    p = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    jt = jl.build_light_table(jsc)
    tt = tl.build_light_table(tsc)
    jstate, jout = jl.sample_lights(jt, jsc, jnp.asarray(state),
                                    jnp.asarray(p))
    tstate, tout = tl.sample_lights(tt, tsc, torch.from_numpy(
        state.astype(np.int64)), t_(p))
    np.testing.assert_array_equal(_u32(tstate), np.asarray(jstate))
    # lanes whose u lies within 1e-6 of a CDF step may pick either light
    _, u = js.uniform(jnp.asarray(state))
    near = (np.abs(np.asarray(u)[:, None] - np.asarray(jt.cdf)[None, :])
            < 1e-6).any(1)
    same = ~near
    assert same.mean() > 0.99
    np.testing.assert_array_equal(tout["light_prim"].numpy()[same],
                                  np.asarray(jout["light_prim"])[same])
    np.testing.assert_array_equal(tout["ok"].numpy()[same],
                                  np.asarray(jout["ok"])[same])
    # absolute floors where a difference of near-equal numbers carries the
    # last-bit difference of its terms, not its own: a component of
    # wi = light point - p near zero (|terms| ~ 30, an ulp ~ 2e-6), and
    # inv_pdf_w = area |cos_l| / d² / P at grazing cos_l
    atol = {"wi": 1e-5, "dist": 0.0, "radiance": 0.0, "inv_pdf_w": 1e-5}
    for k, a in atol.items():
        np.testing.assert_allclose(tout[k].numpy()[same],
                                   np.asarray(jout[k])[same], rtol=1e-5,
                                   atol=a, err_msg=k)


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("s", [0.0, 0.3, 0.5, 0.7, 0.99])
def test_glossy_mix_pdf_matches_reference(s, cosine):
    rng = np.random.default_rng(11)
    n = 4096
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d_in = rng.normal(size=(n, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    refl = d_in - 2.0 * (d_in * nrm).sum(1, keepdims=True) * nrm
    # directions near the mirror direction, where the lobe lives
    wi = refl + rng.normal(size=(n, 3)) * 0.6 * (1.0 - s)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wi, refl, nrm = (x.astype(np.float32) for x in (wi, refl, nrm))
    sv = np.full((n,), s, np.float32)
    want = np.asarray(jl.glossy_mix_pdf(jnp.asarray(wi), jnp.asarray(refl),
                                        jnp.asarray(nrm), jnp.asarray(sv),
                                        cosine))
    got = tl.glossy_mix_pdf(t_(wi), t_(refl), t_(nrm), t_(sv), cosine)
    assert (want > 0).mean() > 0.3
    # atol: at the lobe's rim sqrt(disc) -> 0 amplifies last-bit differences
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
