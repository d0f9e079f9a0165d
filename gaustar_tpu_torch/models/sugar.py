"""SuGaR: mesh-bound Gaussian parametrization (counterpart of
gaustar_tpu/models/sugar.py; sugar_model.py:83-1437).

  - each triangle hosts `n_gaussians_per_face` Gaussians at fixed barycentric
    coordinates (tables of sugar_model.py:186-226);
  - 2 learnable in-plane log-scales; the 3rd axis is the surface thickness;
  - rotation = face frame (normal, first edge, normal x edge) spun in-plane by
    a learnable complex number;
  - opacity logits -> sigmoid strengths; SH colour per gaussian;
  - loose bind: delta_t translation and delta_r quaternion per gaussian;
  - the mesh vertices are learnable.

The covariance is assembled from the face frame, Sigma = U diag(s^2) U^T,
component by component as in the JAX package. Face-count bucketing (the
JAX config's `face_mask`) is not part of the port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops import segment
from gaustar_tpu_torch.ops import sh as sh_ops
from gaustar_tpu_torch.ops.knn import knn_points
from gaustar_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from gaustar_tpu_torch.utils.general import inverse_sigmoid, matrix_to_quaternion, resolve_device
from gaustar_tpu_torch.utils.profiling import span

_SQRT3 = float(np.sqrt(3.0))

BARY_TABLES = {
    1: (1.0 / (2.0 * _SQRT3), [[1 / 3, 1 / 3, 1 / 3]]),
    3: (
        1.0 / (2.0 * (_SQRT3 + 1.0)),
        [[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]],
    ),
    4: (
        1.0 / (4.0 * _SQRT3),
        [
            [1 / 3, 1 / 3, 1 / 3],
            [2 / 3, 1 / 6, 1 / 6],
            [1 / 6, 2 / 3, 1 / 6],
            [1 / 6, 1 / 6, 2 / 3],
        ],
    ),
    6: (
        1.0 / (4.0 + 2.0 * _SQRT3),
        [
            [2 / 3, 1 / 6, 1 / 6],
            [1 / 6, 2 / 3, 1 / 6],
            [1 / 6, 1 / 6, 2 / 3],
            [1 / 6, 5 / 12, 5 / 12],
            [5 / 12, 1 / 6, 5 / 12],
            [5 / 12, 5 / 12, 1 / 6],
        ],
    ),
}


@dataclasses.dataclass
class SuGaRParams:
    """Learnable leaf tensors; the optimizer's named groups are these fields."""

    points: torch.Tensor  # [V, 3] mesh vertices
    scales: torch.Tensor  # [N, 2] log in-plane scales
    complex2d: torch.Tensor  # [N, 2] in-plane rotation
    densities: torch.Tensor  # [N, 1] opacity logits
    sh_dc: torch.Tensor  # [N, 1, 3]
    sh_rest: torch.Tensor  # [N, K-1, 3]
    delta_t: torch.Tensor  # [N, 3] loose-bind translation
    delta_r: torch.Tensor  # [N, 4] loose-bind quaternion (w-first)

    def named(self):
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]


@dataclasses.dataclass
class SuGaRConfig:
    faces: torch.Tensor  # [F, 3] int64
    bary: torch.Tensor  # [n_g, 3]
    thickness: torch.Tensor  # []
    n_gaussians_per_face: int
    sh_levels: int
    min_scale: float | None
    max_scale: float | None
    loose_bind: bool = False
    # (order, offsets) backward tables of the verts[faces] gather (ops/segment.py).
    face_gather: tuple | None = None


def make_params(arrays: dict, device) -> SuGaRParams:
    """SuGaRParams of fresh float32 leaves requiring grad, from arrays. The
    leaves are copies: the optimizer updates them in place, and on the CPU a
    tensor made with as_tensor would share the caller's buffer."""
    return SuGaRParams(
        **{
            f.name: torch.tensor(np.asarray(arrays[f.name], np.float32), device=device, requires_grad=True)
            for f in dataclasses.fields(SuGaRParams)
        }
    )


def fresh_params(params: SuGaRParams, **new) -> SuGaRParams:
    """SuGaRParams of fresh leaves requiring grad: the fields in `new`
    replaced, the others copied (the optimizer updates leaves in place, so
    a model that must not change is never shared)."""
    return SuGaRParams(**{k: new.get(k, v).detach().clone().requires_grad_() for k, v in params.named()})


def init_sugar(
    verts: np.ndarray,
    faces: np.ndarray,
    vertex_colors: np.ndarray | None = None,
    n_gaussians_per_face: int = 6,
    sh_levels: int = 3,
    thickness: float = 1e-6,
    min_scale: float | None = None,
    max_scale: float | None = None,
    colors: np.ndarray | None = None,
    device="cuda",
) -> tuple[SuGaRParams, SuGaRConfig]:
    """Bind a gaussian cloud to a mesh (sugar_model.py:164-404 init path)."""
    dev = resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    circle_radius, bary = BARY_TABLES[n_gaussians_per_face]
    bary = np.asarray(bary, np.float32)
    f = len(faces)
    n = f * n_gaussians_per_face

    faces_verts = verts[faces]
    edge_len = np.linalg.norm(faces_verts - faces_verts[:, [1, 2, 0]], axis=-1)
    s0 = np.clip(edge_len.min(axis=-1) * circle_radius, 1e-7, None)
    scales = np.log(np.repeat(s0, n_gaussians_per_face))[:, None].repeat(2, 1).astype(np.float32)

    complex2d = np.zeros((n, 2), np.float32)
    complex2d[:, 0] = 1.0
    densities = inverse_sigmoid(torch.full((n, 1), 0.1, dtype=torch.float32)).numpy()

    if colors is None:
        if vertex_colors is None:
            vertex_colors = np.full((len(verts), 3), 0.5, np.float32)
        face_colors = np.asarray(vertex_colors, np.float32)[faces]
        colors = (face_colors[:, None] * bary[None, :, :, None]).sum(axis=2).reshape(n, 3)
    sh_dc = sh_ops.rgb_to_sh(np.asarray(colors, np.float32))[:, None, :].astype(np.float32)
    sh_rest = np.zeros((n, sh_levels**2 - 1, 3), np.float32)

    delta_t = np.zeros((n, 3), np.float32)
    delta_r = np.zeros((n, 4), np.float32)
    delta_r[:, 0] = 1.0

    params = make_params(
        dict(points=verts, scales=scales, complex2d=complex2d, densities=densities,
             sh_dc=sh_dc, sh_rest=sh_rest, delta_t=delta_t, delta_r=delta_r),
        dev,
    )
    config = SuGaRConfig(
        faces=torch.as_tensor(faces, dtype=torch.int64, device=dev),
        bary=torch.as_tensor(bary, device=dev),
        thickness=torch.tensor(thickness, dtype=torch.float32, device=dev),
        n_gaussians_per_face=n_gaussians_per_face,
        sh_levels=sh_levels,
        min_scale=min_scale,
        max_scale=max_scale,
        face_gather=segment.gather_tables(faces, len(verts), dev),
    )
    return params, config


def _face_vert_comps(params: SuGaRParams, config: SuGaRConfig):
    """Face corner coordinates as 9 component tensors v[k][d] of shape [F]."""
    f = config.faces.shape[0]
    fv = segment.gather_rows(params.points, config.faces.reshape(-1), config.face_gather).reshape(f, 3, 3)
    return [[fv[:, k, d] for d in range(3)] for k in range(3)]


def _cross3(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _normalize3(v, eps=1e-12):
    # Clamp INSIDE the sqrt: a degenerate face gets gradient 0, not 0 * inf.
    sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    n = torch.sqrt(torch.maximum(sq, sq.new_full((), eps * eps)))
    return [v[0] / n, v[1] / n, v[2] / n]


def gaussian_centers(params: SuGaRParams, config: SuGaRConfig, v=None) -> torch.Tensor:
    """Barycentric gaussian centers (+ delta_t when loose), [N, 3]."""
    if v is None:
        v = _face_vert_comps(params, config)
    bary = config.bary
    comps = [
        v[0][d][:, None] * bary[None, :, 0]
        + v[1][d][:, None] * bary[None, :, 1]
        + v[2][d][:, None] * bary[None, :, 2]
        for d in range(3)
    ]
    pts = torch.stack(comps, dim=-1).reshape(-1, 3)
    if config.loose_bind:
        pts = pts + params.delta_t
    return pts


def strengths(params: SuGaRParams) -> torch.Tensor:
    return torch.sigmoid(params.densities.reshape(-1))


def scaling(params: SuGaRParams, config: SuGaRConfig) -> torch.Tensor:
    """[N, 3] = (thickness, s1, s2) (sugar_model.py:457-476)."""
    plane = torch.exp(params.scales)
    if config.max_scale is not None:
        plane = torch.minimum(plane, plane.new_full((), config.max_scale))
    if config.min_scale is not None:
        plane = torch.maximum(plane, plane.new_full((), config.min_scale))
    thick = config.thickness.expand(plane.shape[0], 1)
    return torch.cat([thick, plane], dim=-1)


def _frame_cols_soa(params: SuGaRParams, config: SuGaRConfig, v=None):
    """Rotation columns (r0 | r1 | r2) as component tensors [F, ng]."""
    if v is None:
        v = _face_vert_comps(params, config)
    e1 = [v[1][d] - v[0][d] for d in range(3)]
    e2 = [v[2][d] - v[0][d] for d in range(3)]
    r0f = _normalize3(_cross3(e1, e2))
    b1 = _normalize3([v[0][d] - v[1][d] for d in range(3)])
    b2 = _normalize3(_cross3(r0f, b1))

    ng = config.n_gaussians_per_face
    cx = params.complex2d[:, 0].reshape(-1, ng)
    cy = params.complex2d[:, 1].reshape(-1, ng)
    cn = torch.sqrt(cx * cx + cy * cy)
    cn = torch.maximum(cn, cn.new_full((), 1e-12))
    ca, cb = cx / cn, cy / cn

    shape = ca.shape
    r0 = [r0f[d][:, None].expand(shape) for d in range(3)]
    r1 = [ca * b1[d][:, None] + cb * b2[d][:, None] for d in range(3)]
    r2 = [-cb * b1[d][:, None] + ca * b2[d][:, None] for d in range(3)]

    if config.loose_bind:
        sq = (params.delta_r**2).sum(-1, keepdim=True)
        q = params.delta_r / torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))
        r, x, y, z = (q[:, i].reshape(shape) for i in range(4))
        m = (
            (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)),
            (2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)),
            (2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)),
        )

        def rot(c):
            return [m[d][0] * c[0] + m[d][1] * c[1] + m[d][2] * c[2] for d in range(3)]

        r0, r1, r2 = rot(r0), rot(r1), rot(r2)
    return r0, r1, r2


def gaussian_frames(params: SuGaRParams, config: SuGaRConfig) -> torch.Tensor:
    """[N, 3, 3] rotations with columns (normal, in-plane 1, in-plane 2),
    the loose-bind rotation applied (sugar_model.py:478-508)."""
    r0, r1, r2 = _frame_cols_soa(params, config)
    cols = [torch.stack([c[d].reshape(-1) for d in range(3)], dim=-1) for c in (r0, r1, r2)]
    return torch.stack(cols, dim=-1)


def quaternions(params: SuGaRParams, config: SuGaRConfig) -> torch.Tensor:
    """Normalized w-first quaternions of the gaussian frames, for the 3DGS
    export (sugar_model.py:506-508)."""
    return matrix_to_quaternion(gaussian_frames(params, config))


def covariance6(params: SuGaRParams, config: SuGaRConfig, use_solid_surface: bool = False, v=None):
    """Packed world covariance [N, 6] (xx, xy, xz, yy, yz, zz),
    Sigma_de = sum_i s_i^2 r_i[d] r_i[e]."""
    r0, r1, r2 = _frame_cols_soa(params, config, v)
    s = scaling(params, config)
    if use_solid_surface:
        # raise small in-plane scales to their mean (sugar_model.py:1230-1232)
        mean_scale = s[:, 1:].mean()
        s = torch.cat([s[:, :1], torch.maximum(s[:, 1:], mean_scale)], dim=-1)
    ng = config.n_gaussians_per_face
    s2 = [(s[:, i] ** 2).reshape(-1, ng) for i in range(3)]
    entries = [
        s2[0] * r0[d] * r0[e] + s2[1] * r1[d] * r1[e] + s2[2] * r2[d] * r2[e]
        for d, e in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    ]
    return torch.stack([x.reshape(-1) for x in entries], dim=-1)


@span("refine.geometry")
def geom_primitives(params: SuGaRParams, config: SuGaRConfig, use_solid_surface: bool = False):
    """(positions [N, 3], cov6 [N, 6]) from ONE verts[faces] gather, so the
    backward runs one per-vertex reduction."""
    v = _face_vert_comps(params, config)
    return (
        gaussian_centers(params, config, v),
        covariance6(params, config, use_solid_surface, v),
    )


@torch.no_grad()
def compute_density(params: SuGaRParams, config: SuGaRConfig, x: torch.Tensor, k: int = 16,
                    density_factor: float = 1.0) -> torch.Tensor:
    """Density at query points [Q, 3]: over the k gaussians with the nearest
    centres, sum strength * exp(-1/2 shift^T Sigma^-1 shift)
    (compute_density, sugar_model.py:1017-1040). The border-face
    postprocess reads it (refined_mesh.py:1180-1182). The frame products
    are written out elementwise, so no matmul (and no TF32) is involved."""
    centers = gaussian_centers(params, config)
    _, idx = knn_points(x, centers, k=k)  # [Q, k]
    frames = gaussian_frames(params, config)[idx]  # [Q, k, 3, 3], columns are the axes
    inv_s = 1.0 / scaling(params, config)[idx]  # [Q, k, 3]
    shift = x[:, None, :] - centers[idx]  # [Q, k, 3]
    warped = (frames * shift[..., :, None]).sum(-2) * inv_s  # U^T shift / s
    m2 = torch.clamp((warped**2).sum(-1), 0.0, 1e8)
    return (density_factor * strengths(params)[idx] * torch.exp(-0.5 * m2)).sum(-1)


def sh_coordinates(params: SuGaRParams) -> torch.Tensor:
    return torch.cat([params.sh_dc, params.sh_rest], dim=1)


def points_rgb(params: SuGaRParams, positions, camera_center, sh_deg: int) -> torch.Tensor:
    """clamp_min(eval_sh + 0.5, 0) at degree `sh_deg` (get_points_rgb,
    sugar_model.py:674-718)."""
    shc = sh_coordinates(params)[:, : (sh_deg + 1) ** 2]
    return sh_ops.sh_to_rgb(sh_deg, shc, positions, camera_center)


def surface_mesh(params: SuGaRParams, config: SuGaRConfig):
    return params.points, config.faces


def loose_bound(params: SuGaRParams, config: SuGaRConfig) -> tuple[SuGaRParams, SuGaRConfig]:
    """Enable unbinding (sugar_model.py:596-599 loose_bind): the same leaves,
    with delta_t and delta_r now read by the geometry."""
    return params, dataclasses.replace(config, loose_bind=True)


def render(
    params: SuGaRParams,
    config: SuGaRConfig,
    camera: Camera,
    bg=(0.0, 0.0, 0.0),
    sh_deg: int | None = None,
    raster_config: RasterConfig = RasterConfig(),
    point_colors=None,
    use_solid_surface: bool = False,
    means2d_dummy=None,
    geom=None,
    layout: str = "hwc",
):
    """Render an image (render_image_gaussian_rasterizer, sugar_model.py:
    1065-1311): SH evaluated here, covariance from scales and frames.
    `point_colors` overrides the per-gaussian features; `geom` =
    precomputed (positions, cov6)."""
    if sh_deg is None:
        sh_deg = config.sh_levels - 1
    if geom is None:
        positions, cov = geom_primitives(params, config, use_solid_surface)
    else:
        positions, cov = geom
    if point_colors is None:
        colors = points_rgb(params, positions, camera.camera_center, sh_deg)
    else:
        colors = point_colors
    return rasterize(
        positions, cov, strengths(params), colors, camera, bg=bg, config=raster_config,
        means2d_dummy=means2d_dummy, layout=layout,
    )


def render_rgbd(
    params: SuGaRParams,
    config: SuGaRConfig,
    camera: Camera,
    bg=(0.0, 1.0, 0.0),
    sh_deg: int | None = None,
    max_depth: float = 10.0,
    raster_config: RasterConfig = RasterConfig(),
    geom=None,
    layout: str = "hwc",
):
    """RGB and depth in ONE rasterizer pass (4 blend channels): both of the
    reference's passes (refine.py:552-564, 599-632) blend with identical
    weights. Returns (rgb, depth, aux)."""
    if sh_deg is None:
        sh_deg = config.sh_levels - 1
    if geom is None:
        geom = geom_primitives(params, config)
    positions = geom[0]
    with span("render.colour"):
        rgb = points_rgb(params, positions, camera.camera_center, sh_deg)
        view = camera.view
        z = positions @ view[2, :3] + view[2, 3]
        colors4 = torch.cat([rgb, z[:, None]], dim=-1)
    bg4 = (*tuple(bg), max_depth)
    cfg4 = dataclasses.replace(raster_config, channels=4)
    img4, aux = render(
        params, config, camera, bg=bg4, raster_config=cfg4, point_colors=colors4, geom=geom,
        layout=layout,
    )
    if layout == "cm":
        return img4[:3], img4[3], aux
    return img4[..., :3], img4[..., 3], aux


def render_depth(
    params: SuGaRParams,
    config: SuGaRConfig,
    camera: Camera,
    max_depth: float = 10.0,
    raster_config: RasterConfig = RasterConfig(),
    use_solid_surface: bool = False,
):
    """Depth render via the colour-channel trick (refine.py:599-632): view-
    space z blended as colour over background max_depth."""
    positions = gaussian_centers(params, config)
    view = camera.view
    z = positions @ view[2, :3] + view[2, 3]
    point_depth = z[:, None].expand(z.shape[0], 3)
    img, aux = render(
        params, config, camera, bg=(max_depth, max_depth, max_depth),
        raster_config=raster_config, point_colors=point_depth,
        use_solid_surface=use_solid_surface,
    )
    return img[..., 0], aux
