"""pix2pose_torch renders against the JAX package on the same inputs: the
exhaustive z-buffer entry (its plain PyTorch version, which the CPU runs)
against ``rasterize_pallas`` in interpret mode, the windowed scan, the
textured render, and the texture sampler.

Bars, per test:
- exhaustive: the bar of ``tests/test_torch_rasterizer.py`` (masks equal;
  depth within rtol 1e-5 where covered; attributes with median difference
  < 1e-4 and < 0.5 on 99.5% of covered pixels; winning sorted-face id
  equal on >= 99.5% of covered pixels);
- windowed scan, the same algorithm in both: masks equal, depth within
  rtol 1e-5, attributes within atol 1e-4;
- textured: on the CPU the JAX side takes its scan and the port its
  binned plain version, whose edge and tie pixels differ, so masks equal
  on >= 99.5% of pixels and median attribute difference < 1e-3 on pixels
  covered in both;
- texture sampler: rtol 1e-6 (atol 1e-4 for values near zero)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.ops import rasterizer as jrast
from pix2pose_tpu.ops import rasterizer_pallas as rp
from pix2pose_tpu.ops.texture import sample_texture as jsample
from pix2pose_torch.data.synthetic_bop import atlas_texture, uv_cube_mesh
from pix2pose_torch.ops import rasterizer as trast
from pix2pose_torch.ops import rasterizer_cuda as rc
from pix2pose_torch.ops.texture import sample_texture
from pix2pose_torch.utils.synthetic import (cube_mesh, pose_with_euler,
                                            uv_sphere)
from test_torch_rasterizer import _camera, _check, _torch_raw

torch.set_num_threads(1)


@pytest.fixture
def jax_exhaustive(monkeypatch):
    """``rasterize_pallas`` (interpret mode), returning its RenderOut and
    the kernel's face-id buffer."""
    orig = rp._attr_epilogue
    monkeypatch.setattr(rp, "_attr_epilogue",
                        lambda *a, **k: (orig(*a, **k), a[1]))
    fn = jax.jit(rp.rasterize_pallas.__wrapped__,
                 static_argnames=("h", "w", "interpret"))
    return lambda uv, z, f, at, h, w: fn(uv, z, f, at, h, w, interpret=True)


@pytest.mark.parametrize("mesh", ["cube", "sphere"])
def test_exhaustive_matches_jax(jax_exhaustive, mesh):
    h, w = 128, 256
    verts, faces = (cube_mesh(40.0) if mesh == "cube"
                    else uv_sphere(24, 44, 40.0))       # 2024 faces
    R, t = pose_with_euler(yaw=0.4, pitch=-0.3, tx=5.0, ty=-3.0, tz=320.0)
    uv, z = jrast.project_vertices(jnp.asarray(verts), R, t,
                                   jnp.asarray(_camera(h, w)))
    ref, ref_fidx = jax_exhaustive(uv, z, faces, verts, h, w)
    got, got_fidx = _torch_raw(np.asarray(uv)[None], np.asarray(z)[None],
                               faces[None], verts[None], h, w)
    assert np.asarray(ref.mask).sum() > 2000
    _check(ref, ref_fidx,
           trast.RenderOut(got.depth[0], got.attr[0], got.mask[0]),
           got_fidx[0])
    # the public entry takes one mesh, like the JAX function, and runs the
    # plain version for CPU tensors
    args = [torch.as_tensor(np.array(x)) for x in (uv, z, faces, verts)]
    pub = rc.rasterize_exhaustive(*args, h, w)
    assert pub.depth.shape == (h, w) and int(pub.overflow) == 0
    np.testing.assert_array_equal(pub.depth.numpy(), got.depth[0].numpy())
    Rt, tt = torch.as_tensor(R), torch.as_tensor(t)
    via_mesh = rc.render_mesh_exhaustive(args[3], args[2], args[3], Rt, tt,
                                         torch.as_tensor(_camera(h, w)), h, w)
    # (projected by torch here, so edge pixels may flip)
    assert (via_mesh.mask.numpy() == pub.mask.numpy()).mean() >= 0.995
    # K2's tile contract, as in the JAX function
    for fn in (rc.rasterize_exhaustive, rc.rasterize_exhaustive_plain):
        with pytest.raises(ValueError):
            fn(*args, 100, 200)
    with pytest.raises(ValueError):
        rp.rasterize_pallas(uv, z, faces, verts, 100, 200, interpret=True)


def test_windowed_scan_matches_jax():
    verts, faces = uv_sphere(24, 44, 40.0)
    K = _camera(128, 256)
    R, t = pose_with_euler(yaw=0.9, pitch=0.2, tx=-8.0, ty=4.0, tz=300.0)
    uv, z = jrast.project_vertices(jnp.asarray(verts), R, t, jnp.asarray(K))
    v0, u0, h, w = 40, 100, 64, 96
    ref = jrast.rasterize(uv, z, faces, verts, h, w, v0, u0)
    got = trast.rasterize(torch.as_tensor(np.array(uv)),
                          torch.as_tensor(np.array(z)),
                          torch.as_tensor(faces), torch.as_tensor(verts),
                          h, w, v0, u0)
    m = np.asarray(ref.mask)
    assert 500 < m.sum() < h * w        # the window cuts the silhouette
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               rtol=1e-5)
    np.testing.assert_allclose(got.attr.numpy(), np.asarray(ref.attr),
                               atol=1e-4)


def _close_renders(ref, got):
    m_ref, m_got = np.asarray(ref.mask), got.mask.numpy()
    assert m_ref.sum() > 1000
    assert (m_ref == m_got).mean() >= 0.995
    both = m_ref & m_got
    d = np.abs(got.attr.numpy() - np.asarray(ref.attr))[both]
    assert np.median(d) < 1e-3


def test_textured_matches_jax():
    h, w = 128, 128
    K = _camera(h, w)
    T = torch.as_tensor
    cv, cf, cuv, cn = uv_cube_mesh(35.0)
    tex = atlas_texture(96)
    for yaw, ambient in ((0.6, 0.4), (2.2, 0.2)):
        R, t = pose_with_euler(yaw=yaw, pitch=-0.4, roll=0.3, tx=0.0, ty=0.0,
                               tz=260.0)
        ref = jrast.render_textured(cv, cf, cuv, jnp.asarray(tex), cn, R, t,
                                    K, h, w, ambient=ambient,
                                    diffuse=1.0 - ambient)
        got = trast.render_textured(T(cv), T(cf), T(cuv), T(tex), T(cn),
                                    T(R), T(t), T(K), h, w, ambient=ambient,
                                    diffuse=1.0 - ambient)
        _close_renders(ref, got)
        assert float(got.attr.max()) > 50.0    # the atlas, not black


def test_sample_texture_matches_jax():
    rs = np.random.RandomState(0)
    tex = rs.rand(13, 9, 3).astype(np.float32) * 255
    uv = rs.rand(7, 40, 2).astype(np.float32) * 1.4 - 0.2  # incl. clamping
    for flip in (True, False):
        ref = np.asarray(jsample(jnp.asarray(tex), jnp.asarray(uv),
                                 flip_v=flip))
        got = sample_texture(torch.as_tensor(tex), torch.as_tensor(uv),
                             flip_v=flip).numpy()
        assert got.shape == (7, 40, 3)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
