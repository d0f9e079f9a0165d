"""render_composite in the port against the JAX package: a SuGaR model and
the same model under a rigid transform with half of its gaussians masked and
its colours scaled, in one rasterization, on two 48x48 ring cameras.
Images within 1e-5 (the golden tolerance), radii exact. The icosphere's
vertices are jittered: a symmetric mesh seen along its axis has gaussians
at exactly equal depths, whose blend order then rests on the last bit of
each package's depth (XLA's jitted and eager depths already differ there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import index_camera as jindex, stack_cameras
from gaustar_tpu.mesh.primitives import icosphere
from gaustar_tpu.models import compositor as jcomp
from gaustar_tpu.models import sugar as jsugar
from gaustar_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from gaustar_tpu.utils.synthetic import ring_cameras
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.cameras import index_camera
from gaustar_tpu_torch.models import compositor as tcomp
from port_helpers import one_thread, port_sugar  # noqa: F401  (one_thread: autouse)

JRC = JRasterConfig(max_pairs=1 << 15, chunk=32, max_per_tile=4096, impl="jax")


def _rigid(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    t = np.eye(4, dtype=np.float32)
    # a small rotation about the sphere's centre, then a shift
    angle = 0.4
    axis = q[:, 0]
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    centre = np.array([0.0, 0.0, 4.0])
    t[:3, :3] = rot
    t[:3, 3] = centre - rot @ centre + np.array([0.35, 0.1, 0.2])
    return t


@pytest.mark.parametrize("cam", [0, 1])
def test_render_composite_matches_jax(cam):
    rng = np.random.default_rng(0)
    verts, faces = icosphere(1, radius=0.5, center=(0, 0, 4.0))
    verts = (verts + rng.normal(scale=0.01, size=verts.shape)).astype(np.float32)
    jp, jc = jsugar.init_sugar(verts, faces, vertex_colors=rng.uniform(0.2, 0.9, (len(verts), 3)))
    jp = jp.__class__(**{**{k: getattr(jp, k) for k in jp.__dataclass_fields__},
                         "densities": jnp.asarray(rng.normal(1.0, 1.0, size=jp.densities.shape), jnp.float32),
                         "sh_rest": jnp.asarray(rng.normal(scale=0.1, size=jp.sh_rest.shape), jnp.float32)})
    tp, tc = port_sugar(jp, jc)
    n = jp.scales.shape[0]
    mask = np.arange(n) % 2 == 0
    transform = _rigid(1)

    jentries = [jcomp.CompositorEntry(jp, jc),
                jcomp.CompositorEntry(jp, jc, transform=jnp.asarray(transform), mask=jnp.asarray(mask),
                                      color_scale=0.7)]
    tentries = [tcomp.CompositorEntry(tp, tc),
                tcomp.CompositorEntry(tp, tc, transform=torch.as_tensor(transform), mask=torch.as_tensor(mask),
                                      color_scale=0.7)]
    jcams = stack_cameras(ring_cameras(2, w=48, h=48))
    cams = {k: np.asarray(getattr(jcams, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")}
    tcams = bridge.camera_from_numpy(**cams, width=48, height=48, device="cpu")

    jimg, jaux = jax.jit(lambda c: jcomp.render_composite(jentries, c, bg=(0, 1, 0), raster_config=JRC))(
        jindex(jcams, cam))
    with torch.no_grad():
        timg, taux = tcomp.render_composite(tentries, index_camera(tcams, cam), bg=(0, 1, 0))
    assert timg.shape == (48, 48, 3) and taux.radii.shape == (2 * n,)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(taux.radii.numpy(), np.asarray(jaux.radii))
    # the transformed copy shows: the image differs from the first model alone
    with torch.no_grad():
        alone, _ = tcomp.render_composite(tentries[:1], index_camera(tcams, cam), bg=(0, 1, 0))
    assert float((alone - timg).abs().max()) > 0.05
