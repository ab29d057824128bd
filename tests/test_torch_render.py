"""The PyTorch port's renderer (render/camera.py) against the JAX package's,
on the CPU: ``Renderer.render_3d`` at 96 x 64 on tests/test_render.py's
scene and on benchmarks/suite.py's mixed-surface scene, and the anchors of
tests/test_render.py (aperture exclusion, the IOR colormap, the profile
scan's sag, the orbit camera).

Tolerances: pixels equal to 1e-5 (the same float32 formulas; a shading of
|n.l| rounds differently in the last bits) except pixels whose winning row
flips under another rounding (a ray that grazes two rows' hits within an
ulp, or a bound's rim), at most 1 in 500; the colormap, the scan and the
camera to 1e-6 or the JAX tests' own bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.render import camera as jcam
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.render import camera as tcam

torch.set_num_threads(2)

PIXEL_TOL = 1e-5
FLIP_SHARE = 2e-3


def _scene(rt):
    """tests/test_render.py's scene: a singlet, a stop, a sensor and a
    mirror."""
    return rt.Scene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.CircularAperture(radius=5.0, translation=[0.0, 0.0, 10.0],
                            name='stop'),
        rt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                         name='sensor'),
        rt.SphericalMirror(c1=-0.02, d=8.0, translation=[0.0, 0.0, 30.0],
                           name='mirror'),
    ])


SCENES = {'render_test': _scene,
          'mixed': lambda rt: chip_smoke.mixed_scene(rt, 12)}
CAMERA = dict(position=[25.0, 18.0, -25.0], look_at=[0.0, 0.0, 10.0],
              fov_deg=45.0, width=96, height=64)


def _params(js):
    return interop.params_from_numpy(
        {el: {k: np.asarray(v) for k, v in d.items()}
         for el, d in js.init_params().items()}, 'cpu')


@pytest.mark.parametrize('case', sorted(SCENES))
def test_render_matches_jax(case):
    """The image of each scene equals the JAX renderer's, pixel by pixel,
    but for the pixels whose winning row flips."""
    js, ts = SCENES[case](jrt), SCENES[case](trt)
    img_j = np.asarray(jcam.Renderer(js).render_3d(js.init_params(),
                                                   jcam.Camera(**CAMERA)))
    img_t = tcam.Renderer(ts).render_3d(_params(js),
                                        tcam.Camera(**CAMERA)).numpy()
    assert img_t.shape == img_j.shape == (64, 96, 3)
    assert np.isfinite(img_t).all()
    assert img_t.min() >= 0.0 and img_t.max() <= 1.0
    differ = np.abs(img_t - img_j).max(-1) > PIXEL_TOL
    assert differ.mean() <= FLIP_SHARE, differ.sum()
    frac_hit = 1.0 - np.all(img_t == 1.0, axis=-1).mean()
    assert 0.02 < frac_hit < 0.98
    assert img_t.std() > 0.01


def test_render_excludes_apertures():
    """Aperture plates do not occlude what lies behind them: the centre
    pixel of a camera looking down the axis at the stop sees the lens."""
    scene = _scene(trt)
    cam = tcam.Camera(position=[0.0, 0.0, -30.0], look_at=[0.0, 0.0, 0.0],
                      fov_deg=20.0, width=32, height=32)
    img = tcam.Renderer(scene).render_3d(scene.init_params('cpu'),
                                         cam).numpy()
    assert not np.allclose(img[16, 16], [1.0, 1.0, 1.0])
    assert [el.is_aperture for el in scene.elements] == [False, True, False,
                                                         False]


def test_ior_colormap_matches_jax():
    """The colormap's anchors (white, cyan, blue; the white-cyan midpoint)
    and every IOR from below 1 to beyond 2 as the JAX package maps it."""
    for ior, rgb in ((1.0, [0.9, 0.9, 0.9]), (1.3, [0.0, 1.0, 1.0]),
                     (1.4, [0.3, 0.6, 1.0]), (1.15, [0.45, 0.95, 0.95])):
        np.testing.assert_allclose(tcam.ior_color(ior).numpy(), rgb,
                                   atol=1e-6)
    iors = np.linspace(0.8, 2.3, 301).astype(np.float32)
    np.testing.assert_allclose(tcam.ior_color(torch.from_numpy(iors)).numpy(),
                               np.asarray(jcam.ior_color(jnp.asarray(iors))),
                               atol=1e-6)


def test_scan_profile_recovers_lens_sag():
    """The front face's scan is z = -1.5 + sag(c1 = 0.05) inside the
    aperture (tests/test_render.py's bound, 1e-4), invalid outside it, and
    equals the JAX package's scan of the lens's rows."""
    js, ts = _scene(jrt), _scene(trt)
    coords, z, valid = tcam.Renderer(ts).scan_profile(
        _params(js), 0, axis='x', num_points=101, bounds=(-6.0, 6.0))
    coords, z, valid = coords.numpy(), z.numpy(), valid.numpy()
    inside = np.abs(coords) <= 4.9
    assert valid[inside, 0].all()
    sag = 0.05 * coords ** 2 / (1 + np.sqrt(1 - 0.05 ** 2 * coords ** 2))
    np.testing.assert_allclose(z[inside, 0], (-1.5 + sag)[inside], atol=1e-4)
    assert not valid[np.abs(coords) > 5.1, 0].any()
    c_j, z_j, v_j = jcam.Renderer(js).scan_profile(
        js.init_params(), 0, axis='x', num_points=101, bounds=(-6.0, 6.0))
    np.testing.assert_allclose(coords, np.asarray(c_j), atol=1e-6)
    np.testing.assert_array_equal(valid, np.asarray(v_j))
    np.testing.assert_allclose(z[valid], np.asarray(z_j)[valid], atol=1e-5)


def test_orbit_camera_matches_jax():
    """Orbit keeps the radius, zoom shrinks it, pan moves pivot and origin
    alike, roll turns the frame, and every step leaves the JAX camera's
    frame; the rays are unit and equal the JAX camera's."""
    kw = dict(pivot=[0.0, 0.0, 0.0], position=[0.0, 0.0, -30.0],
              look_at=[0.0, 0.0, 0.0], fov_deg=30.0, width=8, height=8)
    cams = (tcam.OrbitCamera(**kw), jcam.OrbitCamera(**kw))
    d0 = float(torch.linalg.norm(cams[0].origin - cams[0].pivot))
    for step in (('orbit', 0.3, 0.1), ('zoom', 1.0), ('pan', 1.0, 0.5),
                 ('roll', 0.2), ('orbit', -0.5, 1.2)):
        for cam in cams:
            getattr(cam, step[0])(*step[1:])
        for f in ('origin', 'pivot', 'forward', 'right', 'up_cam'):
            np.testing.assert_allclose(getattr(cams[0], f).numpy(),
                                       np.asarray(getattr(cams[1], f)),
                                       atol=1e-5, err_msg=f'{step} {f}')
        if step[0] == 'orbit' and step[1] == 0.3:
            np.testing.assert_allclose(
                float(torch.linalg.norm(cams[0].origin - cams[0].pivot)),
                d0, rtol=1e-5)
    rays = cams[0].generate_rays()
    assert rays.pos.shape == (64, 3)
    np.testing.assert_allclose(torch.linalg.norm(rays.dir, dim=1).numpy(),
                               1.0, atol=1e-5)
    np.testing.assert_allclose(rays.dir.numpy(),
                               np.asarray(cams[1].generate_rays().dir),
                               atol=1e-6)
