"""Hash-grid neural radiance field, the HumanRF-equivalent mesh initializer
(counterpart of gaustar_tpu/models/neural_field.py).

The reference's data_process/humanrf (tiny-cuda-nn HashGrid + fused MLPs +
nerfacc volume rendering, humanrf.py:123-156 / decomposition4d.py /
volume_rendering.py) produces the initial 100k-face mesh of frame 0. Here it
is a multi-resolution hash encoding (instant-NGP style), two small MLPs and
ray-marched volume rendering in plain tensor code.

Layout: the hash tables are stored interleaved, [L, T, F] (tiny-cuda-nn's
layout: one F-wide row gather per corner). The JAX package stores them
feature-major, [L, F, T], a TPU tiling workaround; `bridge.py` transposes
between the two. `init_field` draws the values in [L, T, F] order from the
same numpy seed as the JAX package, so both start from identical tables.

The hash is the JAX package's uint32 arithmetic emulated in int64 (torch has
no general uint32 multiply): each corner coordinate times its prime, masked to
32 bits, xor-ed, then taken modulo the table size. The products stay below
2^43, so the indices are equal to the JAX package's.

The tables' gradient is an index-accumulate over the gathered rows (atomic
adds on the card) in float64, rounded once to float32: equal to the JAX
package's float32 scatter-add within float32 rounding, not bitwise.

`FieldConfig()` is the JAX package's reduced field. `instant_ngp()` is the
field at Instant-NGP's published widths (Müller et al. 2022, §4 and Table 1):
16 levels of 2^19 rows, coarse levels indexed 1:1 where their vertices fit
in the table, the colour net fed the density net's 16 outputs and the view
direction's 16 spherical-harmonic values (tiny-cuda-nn's degree 4).

`render_rays` opens the spans field.sample, field.encode, field.mlp and
field.composite (utils/profiling) and counts `field_rays` and
`field_samples`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaustar_tpu_torch.ops.sh import sh_basis
from gaustar_tpu_torch.utils import profiling
from gaustar_tpu_torch.utils.general import resolve_device

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
_CORNERS = [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    n_levels: int = 12
    table_size: int = 1 << 17
    n_features: int = 2
    base_res: int = 16
    max_res: int = 1024
    geo_features: int = 15
    hidden: int = 64
    aabb_min: tuple = (-1.0, -1.0, -1.0)
    aabb_max: tuple = (1.0, 1.0, 1.0)
    n_samples: int = 128
    density_scale: float = 25.0
    # Instant-NGP's options; the defaults keep the JAX package's field.
    sh_degree: int = 0  # the view direction as tiny-cuda-nn's degree-d SH (d^2 values); 0: the raw direction
    feed_density: bool = False  # the colour net takes the density net's whole output, log-density included
    dense_coarse: bool = False  # 1:1 rows at each level whose (N_l + 1)^3 vertices fit in the table

    @property
    def color_inputs(self) -> int:
        """Width of the colour net's input."""
        geo = self.geo_features + (1 if self.feed_density else 0)
        return geo + (self.sh_degree**2 if self.sh_degree else 3)


def instant_ngp(**overrides) -> FieldConfig:
    """The field at Instant-NGP's published widths: L 16, F 2, T 2^19,
    N_min 16, 64-wide MLPs (32 -> 64 -> 16 and 32 -> 64 -> 64 -> 3), the
    colour net fed the 16 density outputs and the SH-4 direction encoding,
    coarse levels 1:1; N_max 2048 and the rest as given."""
    base = dict(n_levels=16, table_size=1 << 19, n_features=2, base_res=16, max_res=2048, geo_features=15,
                hidden=64, sh_degree=4, feed_density=True, dense_coarse=True)
    return FieldConfig(**{**base, **overrides})


class HashGridField(nn.Module):
    """The field's parameters: `tables` [L, T, F] and the two MLPs, each a
    list of (w [in, out], b [out]) layers applied as x @ w + b."""

    def __init__(self, tables: torch.Tensor, mlp_sigma, mlp_color):
        super().__init__()
        self.tables = nn.Parameter(tables)
        self.mlp_sigma = nn.ParameterList([t for layer in mlp_sigma for t in layer])
        self.mlp_color = nn.ParameterList([t for layer in mlp_color for t in layer])


def _mlp_layers(rng, cfg: FieldConfig):
    """The two MLPs' (w, b) layers, drawn in the JAX package's order."""
    def dense(i, o):
        return (rng.normal(0, np.sqrt(2.0 / i), size=(i, o)).astype(np.float32), np.zeros(o, np.float32))

    in_dim = cfg.n_levels * cfg.n_features
    sigma = [dense(in_dim, cfg.hidden), dense(cfg.hidden, 1 + cfg.geo_features)]
    color = [dense(cfg.color_inputs, cfg.hidden), dense(cfg.hidden, cfg.hidden), dense(cfg.hidden, 3)]
    return sigma, color


def _tensors(layers, dev):
    return [tuple(torch.as_tensor(a, device=dev) for a in layer) for layer in layers]


def init_field(cfg: FieldConfig, seed: int = 0, device="cuda") -> HashGridField:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tables = rng.uniform(-1e-4, 1e-4, size=(cfg.n_levels, cfg.table_size, cfg.n_features)).astype(np.float32)
    tables = torch.as_tensor(tables, device=dev)
    sigma, color = _mlp_layers(rng, cfg)
    return HashGridField(tables, _tensors(sigma, dev), _tensors(color, dev))


def level_resolutions(cfg: FieldConfig) -> list[int]:
    """Grid resolution of each level: base_res x growth^level, floored."""
    growth = np.exp(np.log(cfg.max_res / cfg.base_res) / (cfg.n_levels - 1)) if cfg.n_levels > 1 else 1.0
    return [int(np.floor(cfg.base_res * growth**lvl)) for lvl in range(cfg.n_levels)]


def level_dense(cfg: FieldConfig) -> list[bool]:
    """Whether each level is indexed 1:1 (cfg.dense_coarse and its (N_l + 1)^3
    vertices fit in the table) rather than hashed."""
    return [cfg.dense_coarse and (res + 1) ** 3 <= cfg.table_size for res in level_resolutions(cfg)]


def _level_corners(pts01: torch.Tensor, res: int, table_size: int, dense: bool = False):
    """(table rows [N, 8] int64, trilinear weights [N, 8]) of the 8 corners
    of each point's cell at one level: x + y (res + 1) + z (res + 1)^2 where
    `dense`, else the spatial hash modulo the table size."""
    x = pts01 * res
    x0 = torch.floor(x)
    frac = x - x0
    corners = torch.tensor(_CORNERS, device=pts01.device)
    c = x0.to(torch.int64)[:, None, :] + corners[None]
    w3 = torch.where(corners[None] == 1, frac[:, None, :], 1.0 - frac[:, None, :])
    w = w3[..., 0] * w3[..., 1] * w3[..., 2]  # (x y) z, in this order on every device
    if dense:
        return c[..., 0] + (res + 1) * (c[..., 1] + (res + 1) * c[..., 2]), w
    h = (c[..., 0] * _PRIMES[0]) & _MASK32
    h = h ^ ((c[..., 1] * _PRIMES[1]) & _MASK32)
    h = h ^ ((c[..., 2] * _PRIMES[2]) & _MASK32)
    return h % table_size, w


def hash_indices(pts01: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """The table rows [L, N, 8] that hash_encode reads for pts01 [N, 3]."""
    return torch.stack([_level_corners(pts01, res, cfg.table_size, dense)[0]
                        for res, dense in zip(level_resolutions(cfg), level_dense(cfg))])


class _GatherRows(torch.autograd.Function):
    """table[rows] whose backward adds each gathered row's gradient into the
    table's with index_add_ (atomic adds on the card, as tiny-cuda-nn's
    encoding does), in float64 and rounded once to the table's dtype, so
    that the order the atomics take leaves the result as it is (but for
    rare ties). PyTorch's own indexing backward sorts the rows and sums
    each row's duplicates in one thread, so its time follows the longest
    run of one row: the coarse levels' rows, which thousands of samples
    share, made it vary by 10% from one set of views to the next."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.n_rows = table.shape[0]
        return table[rows]

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.n_rows, grad.shape[-1]), dtype=torch.float64)
        out.index_add_(0, rows.reshape(-1), grad.reshape(-1, grad.shape[-1]).to(torch.float64))
        return out.to(grad.dtype), None


def hash_encode(tables: torch.Tensor, pts01: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """Multi-resolution hash encoding: pts01 [N, 3] in [0, 1] -> [N, L*F].
    `tables` [L, T, F]; each corner gathers one F-wide row."""
    feats = []
    for lvl, (res, dense) in enumerate(zip(level_resolutions(cfg), level_dense(cfg))):
        h, w = _level_corners(pts01, res, cfg.table_size, dense)
        feats.append((_GatherRows.apply(tables[lvl], h) * w[..., None]).sum(dim=1))  # [N, F]
    return torch.cat(feats, dim=-1)


def _mlp(params, x):
    n_layers = len(params) // 2
    for i in range(n_layers):
        x = x @ params[2 * i] + params[2 * i + 1]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def _aabb(cfg: FieldConfig, dev):
    return (torch.tensor(cfg.aabb_min, dtype=torch.float32, device=dev),
            torch.tensor(cfg.aabb_max, dtype=torch.float32, device=dev))


def _density_from_encoding(field, enc, inside, cfg: FieldConfig):
    """(sigma [N], the colour net's features [N, G]): the density net's
    outputs after the first, or all of them with cfg.feed_density."""
    out = _mlp(field.mlp_sigma, enc)
    sigma = torch.exp(torch.clamp(out[:, 0], -10.0, 10.0)) * cfg.density_scale
    return torch.where(inside, sigma, torch.zeros_like(sigma)), (out if cfg.feed_density else out[:, 1:])


def _unit_coords(pts: torch.Tensor, cfg: FieldConfig):
    """(pts in the AABB's [0, 1] cube, clamped [N, 3]; inside the AABB [N])."""
    lo, hi = _aabb(cfg, pts.device)
    pts01 = (pts - lo) / (hi - lo)
    inside = ((pts01 >= 0) & (pts01 <= 1)).all(dim=-1)
    return torch.clamp(pts01, 0.0, 1.0), inside


def query_density(field: HashGridField, pts: torch.Tensor, cfg: FieldConfig):
    """pts [N, 3] world -> (sigma [N], geo [N, G]); sigma 0 outside the AABB."""
    pts01, inside = _unit_coords(pts, cfg)
    enc = hash_encode(field.tables, pts01, cfg)
    return _density_from_encoding(field, enc, inside, cfg)


def query_color(field, geo: torch.Tensor, dirs: torch.Tensor, cfg: FieldConfig | None = None) -> torch.Tensor:
    """Colour [N, 3] from the density net's features and unit directions
    [N, 3], the directions SH-encoded where cfg.sh_degree is set."""
    if cfg is not None and cfg.sh_degree:
        dirs = sh_basis(cfg.sh_degree - 1, dirs)
    return torch.sigmoid(_mlp(field.mlp_color, torch.cat([geo, dirs], dim=-1)))


def render_rays(field: HashGridField, origins, dirs, cfg: FieldConfig, jitter=None,
                occupancy: torch.Tensor | None = None):
    """Volume-render rays [R, 3] -> (rgb [R, 3], alpha [R], depth [R]).

    Uniform samples across the ray's [t_near, t_far] slab through the AABB
    (the uniform-stepping core of HumanRF's ray_sampler.cu). `jitter` offsets
    each sample within its step: None for the step centres, a [R, S] tensor
    of uniforms in [0, 1) (the JAX package's jax.random.uniform draws, for
    one), or a torch.Generator to draw them from. With `occupancy` (a
    [G, G, G] grid) the slab is first tightened to the occupied span
    (tighten_ray_bounds)."""
    dev = origins.device
    n = cfg.n_samples
    r = origins.shape[0]
    with profiling.span("field.sample"):
        tmin, tmax = ray_bounds(origins, dirs, cfg, occupancy)
        frac = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
        if isinstance(jitter, torch.Generator):
            jitter = torch.rand((r, n), generator=jitter, device=dev)
        if jitter is not None:
            frac = frac[None] + (torch.as_tensor(jitter, dtype=torch.float32, device=dev) - 0.5) / n
        else:
            frac = frac[None].expand(r, n)
        span = tmax - tmin
        ts = tmin[:, None] + frac * span[:, None]  # [R, S]
        delta = span[:, None] / n
        pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None]  # [R, S, 3]
    profiling.count("field_rays", r)
    profiling.count("field_samples", r * n)

    with profiling.span("field.encode"):
        pts01, inside = _unit_coords(pts.reshape(-1, 3), cfg)
        enc = hash_encode(field.tables, pts01, cfg)
    with profiling.span("field.mlp"):
        sigma, geo = _density_from_encoding(field, enc, inside, cfg)
        rgb = query_color(field, geo, dirs[:, None].expand(pts.shape).reshape(-1, 3), cfg)
        sigma = sigma.reshape(ts.shape)
        rgb = rgb.reshape(*ts.shape, 3)

    with profiling.span("field.composite"):
        alpha = 1.0 - torch.exp(-sigma * delta)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
        w = alpha * trans
        out_rgb = (w[..., None] * rgb).sum(dim=1)
        out_alpha = w.sum(dim=1)
        out_depth = (w * ts).sum(dim=1) / torch.clamp_min(out_alpha, 1e-8)
    return out_rgb, out_alpha, out_depth


def ray_bounds(origins, dirs, cfg: FieldConfig, occupancy: torch.Tensor | None = None):
    """(tmin [R], tmax [R]): each ray's slab through the AABB, tightened to
    the occupied span where an occupancy grid is given."""
    lo, hi = _aabb(cfg, origins.device)
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    t0 = (lo[None] - origins) * inv
    t1 = (hi[None] - origins) * inv
    tmin = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), 1e-3)
    tmax = torch.maximum(torch.maximum(t0, t1).amin(dim=-1), tmin + 1e-3)
    if occupancy is not None:
        tmin, tmax = tighten_ray_bounds(occupancy, origins, dirs, tmin, tmax, cfg)
    return tmin, tmax


@torch.no_grad()
def density_grid(field: HashGridField, cfg: FieldConfig, res: int = 256, chunk: int = 1 << 20) -> torch.Tensor:
    """Dense sigma grid [res, res, res] over the AABB (humanrf
    trainer.py:630-700 extraction), on the field's device. The grid goes by
    batches of x-slices of at most `chunk` points (at least one slice); the
    [res^3, 3] coordinates are never built. The axes come from
    torch.linspace, within 2 float32 ulps of jnp.linspace's values (which
    XLA computes through a reciprocal and a fused multiply-add)."""
    dev = field.tables.device
    lo, hi = _aabb(cfg, dev)
    xs = [torch.linspace(lo[d], hi[d], res, device=dev) for d in range(3)]
    yy, zz = torch.meshgrid(xs[1], xs[2], indexing="ij")
    yz = torch.stack([yy.reshape(-1), zz.reshape(-1)], dim=-1)  # [res^2, 2]
    out = torch.empty((res, res, res), dtype=torch.float32, device=dev)
    step = max(1, chunk // (res * res))
    for i0 in range(0, res, step):
        i1 = min(i0 + step, res)
        x = xs[0][i0:i1, None].expand(i1 - i0, res * res).reshape(-1, 1)
        pts = torch.cat([x, yz.repeat(i1 - i0, 1)], dim=1)
        out[i0:i1] = query_density(field, pts, cfg)[0].reshape(i1 - i0, res, res)
    return out


# ---------------------------------------------------------------------------
# Occupancy grids (HumanRF native/occupancy_grid.cu + ray_sampler.cu:11-78 +
# toolbox occupancy_grid_generation.cu)
# ---------------------------------------------------------------------------


@torch.no_grad()
def occupancy_from_masks(cameras, masks, cfg: FieldConfig, res: int = 64, dilate: int = 1) -> torch.Tensor:
    """Visual-hull carving: [res]^3 occupancy (1.0 / 0.0) over the field AABB,
    on the cameras' device. A cell stays occupied iff its centre projects
    inside the foreground mask in every camera whose frustum sees it
    (occupancy_grid_generation.cu), one camera at a time; `dilate` rounds of
    3^3 max-pooling guard against carving true surface away."""
    dev = cameras[0].device
    lo = np.asarray(cfg.aabb_min, np.float32)
    hi = np.asarray(cfg.aabb_max, np.float32)
    axes = [np.linspace(lo[d] + (hi[d] - lo[d]) / (2 * res), hi[d] - (hi[d] - lo[d]) / (2 * res), res,
                        dtype=np.float32) for d in range(3)]
    centers = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3), device=dev)
    occ = torch.ones(centers.shape[0], dtype=torch.bool, device=dev)
    for cam, mask in zip(cameras, masks):
        mask = torch.as_tensor(mask, device=dev)
        view = cam.view
        fx = cam.width / (2.0 * float(cam.tanfovx))
        fy = cam.height / (2.0 * float(cam.tanfovy))
        cam_pts = centers @ view[:3, :3].T + view[:3, 3]
        z = cam_pts[:, 2]
        zc = torch.clamp_min(z, 1e-6)
        px = cam_pts[:, 0] / zc * fx + cam.cx
        py = cam_pts[:, 1] / zc * fy + cam.cy
        seen = (z > 1e-3) & (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
        ix = torch.clamp(px.to(torch.int64), 0, mask.shape[1] - 1)
        iy = torch.clamp(py.to(torch.int64), 0, mask.shape[0] - 1)
        occ &= torch.where(seen, mask[iy, ix] > 0.5, True)
    grid = occ.reshape(res, res, res).to(torch.float32)
    for _ in range(dilate):
        grid = dilate_occupancy(grid)
    return grid


def occupancy_from_density(field: HashGridField, cfg: FieldConfig, res: int = 64, threshold: float = 1.0,
                           dilate: int = 1) -> torch.Tensor:
    """Occupancy from the trained field itself: sigma at cell centres above
    `threshold`, dilated."""
    grid = (density_grid(field, cfg, res=res) > threshold).to(torch.float32)
    for _ in range(dilate):
        grid = dilate_occupancy(grid)
    return grid


def dilate_occupancy(grid: torch.Tensor) -> torch.Tensor:
    """One round of 3^3 max-pool dilation."""
    return F.max_pool3d(grid[None, None], 3, stride=1, padding=1)[0, 0]


def _occ_lookup(occ: torch.Tensor, pts: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """Nearest-cell occupancy at world points [..., 3] -> [...] (0 / 1)."""
    res = occ.shape[0]
    lo, hi = _aabb(cfg, pts.device)
    u = (pts - lo) / (hi - lo)
    idx = torch.clamp((u * res).to(torch.int64), 0, res - 1)
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    inside = ((u >= 0.0) & (u < 1.0)).all(dim=-1)
    return torch.where(inside, occ.reshape(-1)[flat], torch.zeros((), dtype=occ.dtype, device=occ.device))


@torch.no_grad()
def tighten_ray_bounds(occ: torch.Tensor, origins, dirs, tmin, tmax, cfg: FieldConfig, n_coarse: int = 64,
                       n_bisect: int = 5):
    """Shrink each ray's [tmin, tmax] to its occupied span
    (ray_sampler.cu:11-78): occupancy at n_coarse points along the ray
    brackets the first and last occupied sample, then n_bisect bisection
    steps refine each end. Rays that hit nothing collapse to [tmin, tmin]."""
    dev = origins.device
    frac = (torch.arange(n_coarse, dtype=torch.float32, device=dev) + 0.5) / n_coarse
    ts = tmin[:, None] + frac[None, :] * (tmax - tmin)[:, None]  # [R, K]
    pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    hit = _occ_lookup(occ, pts, cfg) > 0.5  # [R, K]
    any_hit = hit.any(dim=1)
    kidx = torch.arange(n_coarse, device=dev)
    first = torch.where(hit, kidx[None], n_coarse).amin(dim=1)
    last = torch.where(hit, kidx[None], -1).amax(dim=1)
    step = (tmax - tmin) / n_coarse

    def t_at(k):
        return tmin + (k.to(torch.float32) + 0.5) * step

    lo_f = t_at(torch.clamp_min(first - 1, 0))
    hi_f = t_at(first)
    lo_b = t_at(last)
    hi_b = t_at(torch.clamp_max(last + 1, n_coarse - 1))
    for _ in range(n_bisect):
        mid_f = 0.5 * (lo_f + hi_f)
        occ_f = _occ_lookup(occ, origins + dirs * mid_f[:, None], cfg) > 0.5
        lo_f = torch.where(occ_f, lo_f, mid_f)
        hi_f = torch.where(occ_f, mid_f, hi_f)
        mid_b = 0.5 * (lo_b + hi_b)
        occ_b = _occ_lookup(occ, origins + dirs * mid_b[:, None], cfg) > 0.5
        lo_b = torch.where(occ_b, mid_b, lo_b)  # advance the occupied frontier
        hi_b = torch.where(occ_b, hi_b, mid_b)  # shrink only from the empty side
    new_tmin = torch.where(any_hit, torch.maximum(lo_f, tmin), tmin)
    new_tmax = torch.where(any_hit, torch.minimum(hi_b, tmax), tmin)
    return new_tmin, torch.maximum(new_tmax, new_tmin)


# ---------------------------------------------------------------------------
# 4D low-rank temporal decomposition (HumanRF's core representation)
# ---------------------------------------------------------------------------

_PROJ = ((0, 1, 2, 3), (0, 1, 3, 2), (1, 2, 3, 0), (0, 2, 3, 1))  # (kept..., left-out)


class Field4D(nn.Module):
    """HumanRF's Decomposition4D (decomposition4d.py:79-135 +
    tensor_composition.cu:9-56): four hash grids over the coordinate
    projections {xyz, xyt, yzt, xzt}, each modulated by a 1D feature vector
    sampled at the left-out coordinate:

        feat(x, y, z, t) = hash_xyz(x,y,z) * vec_t(t) + hash_xyt(x,y,t) * vec_z(z)
                         + hash_yzt(y,z,t) * vec_x(x) + hash_xzt(x,z,t) * vec_y(y)

    `tables` [4, L, T, F], `vectors` [4, R, L*F], and the MLPs as in
    HashGridField."""

    def __init__(self, tables: torch.Tensor, vectors: torch.Tensor, mlp_sigma, mlp_color):
        super().__init__()
        self.tables = nn.Parameter(tables)
        self.vectors = nn.Parameter(vectors)
        self.mlp_sigma = nn.ParameterList([t for layer in mlp_sigma for t in layer])
        self.mlp_color = nn.ParameterList([t for layer in mlp_color for t in layer])


def init_field4d(cfg: FieldConfig, vector_res: int = 64, seed: int = 0, device="cuda") -> Field4D:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rng.uniform(-1e-4, 1e-4, size=(cfg.n_levels, cfg.table_size, cfg.n_features))  # init_field's 3D table
    sigma, color = _mlp_layers(rng, cfg)
    rng = np.random.default_rng(seed + 1)
    tables = np.stack([rng.uniform(-1e-4, 1e-4, size=(cfg.n_levels, cfg.table_size, cfg.n_features))
                       .astype(np.float32) for _ in range(4)])
    vectors = np.ones((4, vector_res, cfg.n_levels * cfg.n_features), np.float32)
    return Field4D(torch.as_tensor(tables, device=dev), torch.as_tensor(vectors, device=dev),
                   _tensors(sigma, dev), _tensors(color, dev))


def _sample_vector(vec: torch.Tensor, coord01: torch.Tensor) -> torch.Tensor:
    """Align-corners linear sampling of [R, F] at coord01 [N] in [0, 1]."""
    r = vec.shape[0]
    x = coord01 * (r - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, r - 2)
    f = (x - x0.to(torch.float32))[:, None]
    return vec[x0] * (1 - f) + vec[x0 + 1] * f


def hash_encode_4d(field: Field4D, pts01: torch.Tensor, t01: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """[N, 3] spatial (in [0, 1]) + [N] time (in [0, 1]) -> [N, L*F]."""
    coords4 = torch.cat([pts01, t01[:, None]], dim=-1)  # [N, 4]
    out = 0.0
    for pi, proj in enumerate(_PROJ):
        h = hash_encode(field.tables[pi], coords4[:, list(proj[:3])], cfg)
        out = out + h * _sample_vector(field.vectors[pi], coords4[:, proj[3]])
    return out


def query_density_4d(field: Field4D, pts: torch.Tensor, t01: torch.Tensor, cfg: FieldConfig):
    lo, hi = _aabb(cfg, pts.device)
    pts01 = (pts - lo) / (hi - lo)
    inside = ((pts01 >= 0) & (pts01 <= 1)).all(dim=-1)
    enc = hash_encode_4d(field, torch.clamp(pts01, 0.0, 1.0), t01, cfg)
    return _density_from_encoding(field, enc, inside, cfg)


def adaptive_temporal_partition(motion_per_frame, budget: float, max_len: int = 100):
    """Split a frame sequence into segments whose accumulated motion stays
    under `budget` (HumanRF adaptive_temporal_partitioning.py:107).
    motion_per_frame: [T]. Returns a list of (start, end) pairs."""
    segments = []
    start = 0
    acc = 0.0
    for i, m in enumerate(motion_per_frame):
        acc += float(m)
        if acc > budget or (i - start + 1) >= max_len:
            segments.append((start, i + 1))
            start = i + 1
            acc = 0.0
    if start < len(motion_per_frame):
        segments.append((start, len(motion_per_frame)))
    return segments
