"""TSDF fusion: dense volumetric integration on the device, surface
extraction on the host (counterpart of gaustar_tpu/mesh/tsdf.py).

The reference fuses with o3d's ScalableTSDFVolume (gaustar_trainers/
refined_mesh.py:311-459: voxel 8 mm, sdf_trunc 2 cm, RGB-D from the orbit and
rig cameras). Here the volume is a dense grid over the scene's bbox: every
view projects every voxel centre, samples the depth, truncates and keeps a
running weighted average, in plain tensor code on the device.

Scenes larger than one dense block are TILED (fit_tiled_volume): the global
grid splits into uniform-shape blocks sharing one voxel plane; every block
integrates with GLOBAL voxel indices against the GLOBAL origin, so voxels of a
shared plane compute bitwise-identical values in every block and extraction
is seamless.

Surface extraction is marching TETRAHEDRA (6 tets per cube, 16 cases) in host
numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from gaustar_tpu_torch.utils.general import resolve_device

# Voxels integrated per chunk of x-planes: bounds the temporaries of
# `integrate` (about 60 bytes a voxel) whatever the block size.
INTEGRATE_CHUNK_VOXELS = 1 << 23


@dataclasses.dataclass
class TSDFVolume:
    tsdf: torch.Tensor  # [X, Y, Z] float32, init 1.0 (truncated "far")
    weight: torch.Tensor  # [X, Y, Z] float32
    color: torch.Tensor  # [X, Y, Z, 3] float32 running average
    origin: torch.Tensor  # [3] world position of GLOBAL voxel (0,0,0) CENTER
    index_offset: torch.Tensor  # [3] float32 global index of this block's voxel (0,0,0)
    voxel_size: float
    sdf_trunc: float
    truncated: bool = False  # fit_volume_to_points clamped the bbox


def make_volume(origin, dims, voxel_size: float, sdf_trunc: float, index_offset=(0, 0, 0),
                device="cuda") -> TSDFVolume:
    dev = resolve_device(device)
    x, y, z = (int(d) for d in dims)
    return TSDFVolume(
        tsdf=torch.ones((x, y, z), dtype=torch.float32, device=dev),
        weight=torch.zeros((x, y, z), dtype=torch.float32, device=dev),
        color=torch.zeros((x, y, z, 3), dtype=torch.float32, device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
        index_offset=torch.as_tensor(np.asarray(index_offset, np.float32), device=dev),
        voxel_size=float(voxel_size),
        sdf_trunc=float(sdf_trunc),
    )


@torch.no_grad()
def integrate(vol: TSDFVolume, depth: torch.Tensor, rgb: torch.Tensor, intr: torch.Tensor,
              extr: torch.Tensor, depth_trunc: float = 6.0) -> TSDFVolume:
    """Integrate one RGB-D frame (o3d TSDFVolume.integrate semantics: per-voxel
    projective SDF along the optical axis, clamp to [-1, 1] x trunc, weight 1 per
    observation, running average; invalid depth (0 or > depth_trunc) skipped).

    depth [H, W], rgb [H, W, 3], intr 3x3 (cx, cy explicit), extr 4x4 w2c.
    Updates `vol` in place, a chunk of x-planes at a time, and returns it.
    """
    X, Y, Z = vol.tsdf.shape
    h, w = depth.shape
    dev = vol.tsdf.device
    f32 = torch.float32
    vs = torch.tensor(vol.voxel_size, dtype=f32, device=dev)
    # GLOBAL voxel coordinates, the JAX package's expression
    # origin + (idx + index_offset) * voxel_size, one axis at a time: tiled
    # blocks sharing a voxel plane evaluate the same float operations for it.
    axes = [vol.origin[d] + (torch.arange(n, device=dev).to(f32) + vol.index_offset[d]) * vs
            for d, n in enumerate((X, Y, Z))]
    px, py, pz = axes[0][:, None, None], axes[1][None, :, None], axes[2][None, None, :]
    rot, trans = extr[:3, :3].to(f32), extr[:3, 3].to(f32)
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    step = max(1, INTEGRATE_CHUNK_VOXELS // max(Y * Z, 1))
    for x0 in range(0, X, step):
        xs = slice(x0, min(x0 + step, X))
        # local = R p + t, term by term (no matmul: every element takes the
        # same operations whatever the chunk's shape).
        lx, ly, zc = (px[xs] * rot[d, 0] + py * rot[d, 1] + pz * rot[d, 2] + trans[d] for d in range(3))
        u = fx * lx / zc + cx
        v = fy * ly / zc + cy
        # Clamped before the integer cast (out of range is undefined); the
        # clamp moves no voxel across the image border.
        ui = torch.round(torch.clamp(u, -2.0, w + 1.0)).to(torch.int64)
        vi = torch.round(torch.clamp(v, -2.0, h + 1.0)).to(torch.int64)
        inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (zc > 0)
        ui_c = torch.clamp(ui, 0, w - 1)
        vi_c = torch.clamp(vi, 0, h - 1)
        d = depth[vi_c, ui_c]
        c = rgb[vi_c, ui_c]

        valid = inside & (d > 0) & (d <= depth_trunc)
        sdf = d - zc
        valid = valid & (sdf > -vol.sdf_trunc)
        tsdf_obs = torch.clamp_max(sdf / vol.sdf_trunc, 1.0)

        w_old = vol.weight[xs]
        w_new = w_old + valid.to(f32)
        w_safe = torch.clamp_min(w_new, 1.0)
        t_old = vol.tsdf[xs]
        c_old = vol.color[xs]
        vol.tsdf[xs] = torch.where(valid, (t_old * w_old + tsdf_obs) / w_safe, t_old)
        vol.color[xs] = torch.where(valid[..., None], (c_old * w_old[..., None] + c) / w_safe[..., None], c_old)
        vol.weight[xs] = w_new
    return vol


# Tetrahedral decomposition of a cube (corner ids 0..7 = (dx, dy, dz) bits
# x*4 + y*2 + z). Each cube splits into 6 tets sharing the main diagonal 0-7.
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
)
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ]
)


def _tet_triangles(code):
    """Triangulation (as corner-pair edges) for a tet sign code (bit i = corner i
    inside). Returns list of triangles, each a list of 3 (a, b) edges."""
    cases = {
        0b0001: [[(0, 1), (0, 2), (0, 3)]],
        0b0010: [[(1, 0), (1, 3), (1, 2)]],
        0b0100: [[(2, 0), (2, 1), (2, 3)]],
        0b1000: [[(3, 0), (3, 2), (3, 1)]],
        0b0011: [[(0, 2), (1, 3), (0, 3)], [(0, 2), (1, 2), (1, 3)]],
        0b0101: [[(0, 1), (2, 3), (0, 3)], [(0, 1), (2, 1), (2, 3)]],
        0b1001: [[(0, 1), (0, 2), (3, 2)], [(0, 1), (3, 2), (3, 1)]],
        0b0110: [[(1, 0), (2, 3), (1, 3)], [(1, 0), (2, 0), (2, 3)]],
        0b1010: [[(1, 0), (1, 2), (3, 2)], [(3, 0), (1, 0), (3, 2)]],
        0b1100: [[(2, 0), (2, 1), (3, 1)], [(3, 0), (2, 0), (3, 1)]],
    }
    if code in cases:
        return cases[code], False
    inv = (~code) & 0xF
    if inv in cases:
        return cases[inv], True
    return [], False


# Precompute per-code edge triangles once.
_TET_CASES = {}
for _code in range(16):
    _tris, _flip = _tet_triangles(_code)
    _TET_CASES[_code] = (_tris, _flip)


_EMPTY_MESH = (
    np.zeros((0, 3), np.float32),
    np.zeros((0, 3), np.int32),
    np.zeros((0, 3), np.float32),
)


def _block_triangles(
    tsdf: np.ndarray,
    weight: np.ndarray,
    color: np.ndarray | None,
    origin: np.ndarray,
    vs: float,
    goff=(0, 0, 0),
    gdims=None,
    own_lo=(0, 0, 0),
    own_hi=None,
):
    """Marching-tets triangles of one block, keyed by GLOBAL edge identity.

    `goff` is the block's global voxel offset, `gdims` the global grid dims,
    and [own_lo, own_hi) the LOCAL cube-index range this block owns (tiled
    blocks overlap by one voxel plane; ownership makes each cube extracted
    exactly once). Returns (keys [T, 3] int64, vpos [T, 3, 3] f32 world
    positions, vcol [T, 3, 3] f32), already outward-oriented. The edge key is
    `corner_lin * 32 + direction_code` (direction in {-1,0,1}^3 from the
    smaller-linear corner), which stays in int64 up to ~10^5 global voxels per
    axis — unlike lo*G+hi which overflows past 2000^3.
    """
    X, Y, Z = tsdf.shape
    if gdims is None:
        gdims = (X, Y, Z)
    GX, GY, GZ = (int(g) for g in gdims)
    goff = np.asarray(goff, np.int64)
    if own_hi is None:
        own_hi = (X - 1, Y - 1, Z - 1)
    empty = (
        np.zeros((0, 3), np.int64),
        np.zeros((0, 3, 3), np.float32),
        np.zeros((0, 3, 3), np.float32),
    )

    valid = weight > 0
    # cube validity: all 8 corners valid (the o3d convention)
    cv = valid[:-1, :-1, :-1]
    for dx, dy, dz in _CUBE_CORNERS[1:]:
        cv = cv & valid[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
    # sign change presence (cheap cull)
    neg = tsdf < 0
    any_neg = np.zeros_like(cv)
    all_neg = np.ones_like(cv)
    for dx, dy, dz in _CUBE_CORNERS:
        s = neg[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
        any_neg |= s
        all_neg &= s
    active = cv & any_neg & ~all_neg
    # ownership clip (tiled blocks overlap by one voxel plane)
    mask = np.zeros_like(active)
    mask[own_lo[0] : own_hi[0], own_lo[1] : own_hi[1], own_lo[2] : own_hi[2]] = True
    active &= mask
    ci, cj, ck = np.nonzero(active)
    if len(ci) == 0:
        return empty

    base = np.stack([ci, cj, ck], axis=1)  # [C, 3]
    corner_idx = base[:, None, :] + _CUBE_CORNERS[None]  # [C, 8, 3] local
    d = tsdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # [C, 8]

    tri_a, tri_b = [], []  # [R, 3] tet-local corner slots per triangle vertex
    tri_rows = []
    for tet in _TETS:
        dt = d[:, tet]  # [C, 4]
        code = ((dt < 0) * (1 << np.arange(4))[None]).sum(axis=1)  # [C]
        for cval in range(1, 15):
            rows = np.nonzero(code == cval)[0]
            if len(rows) == 0:
                continue
            tris, flip = _TET_CASES[cval]
            for tri in tris:
                pairs = tri if not flip else tri[::-1]
                tri_a.append(np.stack([np.full(len(rows), tet[a]) for a, b in pairs], axis=1))
                tri_b.append(np.stack([np.full(len(rows), tet[b]) for a, b in pairs], axis=1))
                tri_rows.append(rows)

    if not tri_a:
        return empty

    slot_a = np.concatenate(tri_a)  # [T, 3] cube-corner slot of endpoint a
    slot_b = np.concatenate(tri_b)
    rows = np.concatenate(tri_rows)  # [T]

    # Per-triangle-vertex endpoint data (local coords, values, colors).
    r3 = rows[:, None]
    ca = corner_idx[r3, slot_a]  # [T, 3, 3] local corner coords
    cb = corner_idx[r3, slot_b]
    da = d[r3, slot_a]  # [T, 3]
    db = d[r3, slot_b]

    # Canonical edge identity in GLOBAL coordinates: smaller-linear corner
    # first, plus a 27-way direction code (delta in {-1,0,1}^3).
    ga = ca + goff  # [T, 3, 3] global corner coords
    gb = cb + goff
    lin_a = (ga[..., 0] * GY + ga[..., 1]) * GZ + ga[..., 2]
    lin_b = (gb[..., 0] * GY + gb[..., 1]) * GZ + gb[..., 2]
    swap = lin_b < lin_a
    lin_lo = np.where(swap, lin_b, lin_a)
    g_lo = np.where(swap[..., None], gb, ga)
    g_hi = np.where(swap[..., None], ga, gb)
    d_lo = np.where(swap, db, da).astype(np.float32)
    d_hi = np.where(swap, da, db).astype(np.float32)
    delta = g_hi - g_lo  # each component in {-1, 0, 1}
    dir_code = (delta[..., 0] + 1) * 9 + (delta[..., 1] + 1) * 3 + (delta[..., 2] + 1)
    keys = lin_lo * 32 + dir_code  # [T, 3] int64

    # Interpolated world positions/colors — computed from the CANONICAL
    # endpoint order so overlapping blocks produce bitwise-identical values.
    denom = d_lo - d_hi
    t = np.clip(
        np.where(np.abs(denom) < 1e-12, 0.5, d_lo / np.where(denom == 0, 1, denom)),
        0.0, 1.0,
    )[..., None]
    vpos = (origin + (g_lo + t * (g_hi - g_lo)) * vs).astype(np.float32)  # [T, 3, 3]

    if color is not None:
        c_lo_local = np.where(swap[..., None], cb, ca)
        c_hi_local = np.where(swap[..., None], ca, cb)
        cola = color[c_lo_local[..., 0], c_lo_local[..., 1], c_lo_local[..., 2]]
        colb = color[c_hi_local[..., 0], c_hi_local[..., 1], c_hi_local[..., 2]]
        vcol = (cola + t * (colb - cola)).astype(np.float32)
    else:
        vcol = np.zeros_like(vpos)

    # Consistent outward orientation: flip each face whose normal opposes the
    # local TSDF gradient (tsdf increases outward). Winding reversal = reversing
    # the triangle's vertex order, applied to keys/vpos/vcol together.
    grad = np.stack(np.gradient(tsdf), axis=-1)  # [X, Y, Z, 3]
    centroid_local = (vpos.mean(axis=1) - origin) / vs - goff
    gi = np.clip(np.round(centroid_local).astype(int), 0, np.array(tsdf.shape) - 1)
    g = grad[gi[:, 0], gi[:, 1], gi[:, 2]]
    n = np.cross(vpos[:, 1] - vpos[:, 0], vpos[:, 2] - vpos[:, 0])
    flip = (n * g).sum(-1) < 0
    keys[flip] = keys[flip][:, ::-1]
    vpos[flip] = vpos[flip][:, ::-1]
    vcol[flip] = vcol[flip][:, ::-1]
    return keys, vpos, vcol


def _merge_triangles(parts):
    """Merge per-block (keys, vpos, vcol) triangle soups into (verts, faces,
    colors): vertices dedup by global edge key (overlapping blocks produce
    bitwise-identical positions for shared edges, so first-occurrence wins)."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return _EMPTY_MESH
    keys = np.concatenate([p[0] for p in parts])  # [T, 3]
    vpos = np.concatenate([p[1] for p in parts])
    vcol = np.concatenate([p[2] for p in parts])
    flat = keys.reshape(-1)
    uniq, first, inv = np.unique(flat, return_index=True, return_inverse=True)
    verts = vpos.reshape(-1, 3)[first]
    colors = vcol.reshape(-1, 3)[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    good = (
        (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good], colors.astype(np.float32)


def extract_mesh(vol: TSDFVolume, with_color: bool = True):
    """Marching tetrahedra over the dense volume -> (verts, faces, colors).

    A cube participates only if all 8 corners were observed (weight > 0), the
    o3d convention. Vertices on shared edges are merged by exact edge identity.
    """
    tsdf = vol.tsdf.cpu().numpy()
    offset = vol.index_offset.cpu().numpy()
    part = _block_triangles(
        tsdf,
        vol.weight.cpu().numpy(),
        vol.color.cpu().numpy() if with_color else None,
        vol.origin.cpu().numpy(),
        vol.voxel_size,
        goff=offset.astype(np.int64),
        gdims=tuple(int(s + o) for s, o in zip(tsdf.shape, offset)),
    )
    return _merge_triangles([part])


def fit_volume_to_points(points, voxel_size: float, sdf_trunc: float, pad: float = 0.05, max_dim: int = 512,
                         device="cuda") -> TSDFVolume:
    """A dense volume covering a point set with padding, dims a multiple of 16.
    If the padded bbox needs more than `max_dim` voxels along an axis the
    volume is clamped, geometry outside it is lost (a warning says so) and
    `.truncated` is set; fit_tiled_volume loses nothing."""
    points = np.asarray(points)
    lo = points.min(axis=0) - pad
    hi = points.max(axis=0) + pad
    needed = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    needed = (needed + 15) // 16 * 16
    dims = np.minimum(needed, max_dim)
    truncated = bool((needed > max_dim).any())
    if truncated:
        warnings.warn(
            f"fit_volume_to_points: bbox needs dims {needed.tolist()} voxels at "
            f"voxel_size={voxel_size}, clamped to max_dim={max_dim}; geometry "
            f"outside {(max_dim * voxel_size):.3f} m per axis will be lost. "
            f"Raise max_dim or voxel_size.",
            stacklevel=2,
        )
    vol = make_volume(lo, tuple(int(d) for d in dims), voxel_size, sdf_trunc, device=device)
    vol.truncated = truncated
    return vol


@dataclasses.dataclass
class TiledPlan:
    """Host-side tiling plan of an unbounded fusion volume (the o3d
    ScalableTSDFVolume equivalent, refined_mesh.py:329): the global grid is
    covered by uniform-shape blocks sharing one voxel plane, integrated in
    GLOBAL voxel coordinates. Blocks are made one at a time (`make_block`),
    so only one lives on the device during fusion."""

    origin: np.ndarray  # [3] world position of global voxel (0,0,0)
    global_dims: tuple
    block_dims: tuple  # uniform block shape (voxels)
    offsets: np.ndarray  # [B, 3] int global voxel offset per block
    owned_lo: np.ndarray  # [B, 3] local cube range owned by each block
    owned_hi: np.ndarray  # [B, 3] (exclusive)
    voxel_size: float
    sdf_trunc: float

    @property
    def n_blocks(self) -> int:
        return len(self.offsets)

    def make_block(self, b: int, device="cuda") -> TSDFVolume:
        return make_volume(
            self.origin, self.block_dims, self.voxel_size, self.sdf_trunc,
            index_offset=tuple(int(v) for v in self.offsets[b]), device=device,
        )


def fit_tiled_volume(points, voxel_size: float, sdf_trunc: float, pad: float = 0.05, max_block: int = 512) -> TiledPlan:
    """Tiling plan covering a point set with padding; no geometry is ever
    dropped. Scenes fitting one `max_block`^3 block (any human capture at
    8 mm) get exactly one block, the dense fast path."""
    points = np.asarray(points)
    lo = points.min(axis=0) - pad
    hi = points.max(axis=0) + pad
    needed = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    # Multiples of 16, the JAX package's dims (it buckets them so that its
    # compiled programs survive small bbox drifts). The padding reaches up to
    # 15 voxels past the bbox, where free space is observed; free space alone
    # makes no sign change, so no faces.
    gdims = np.maximum((needed + 15) // 16 * 16, 16)

    axes = []
    for gd in gdims:
        bd = int(min(max_block, gd))
        gcubes = max(gd - 1, 1)
        bc = max(bd - 1, 1)
        nb = -(-gcubes // bc)  # ceil
        offs, olo, ohi = [], [], []
        for i in range(nb):
            own_g_lo = i * bc
            own_g_hi = min((i + 1) * bc, gcubes)
            off = i * bc if i < nb - 1 else gd - bd  # last block right-aligned
            offs.append(off)
            olo.append(own_g_lo - off)
            ohi.append(own_g_hi - off)
        axes.append((bd, offs, olo, ohi))

    bdims = tuple(a[0] for a in axes)
    offsets, owned_lo, owned_hi = [], [], []
    for ix in range(len(axes[0][1])):
        for iy in range(len(axes[1][1])):
            for iz in range(len(axes[2][1])):
                offsets.append([axes[0][1][ix], axes[1][1][iy], axes[2][1][iz]])
                owned_lo.append([axes[0][2][ix], axes[1][2][iy], axes[2][2][iz]])
                owned_hi.append([axes[0][3][ix], axes[1][3][iy], axes[2][3][iz]])
    return TiledPlan(
        origin=lo.astype(np.float32),
        global_dims=tuple(int(g) for g in gdims),
        block_dims=bdims,
        offsets=np.asarray(offsets, np.int64),
        owned_lo=np.asarray(owned_lo, np.int64),
        owned_hi=np.asarray(owned_hi, np.int64),
        voxel_size=float(voxel_size),
        sdf_trunc=float(sdf_trunc),
    )


def extract_mesh_tiled(plan: TiledPlan, host_blocks, with_color: bool = True):
    """Extract the seamless surface from integrated blocks.

    `host_blocks`: list of (tsdf, weight, color) numpy triples, one per plan
    block (color may be None). Blocks share one voxel plane; each cube is owned
    by exactly one block and shared-edge vertices dedup exactly by global edge
    key (values are bitwise identical across blocks — same program, same
    global coordinates)."""
    parts = []
    for b, (ts, wt, col) in enumerate(host_blocks):
        parts.append(
            _block_triangles(
                np.asarray(ts), np.asarray(wt),
                np.asarray(col) if (with_color and col is not None) else None,
                np.asarray(plan.origin), plan.voxel_size,
                goff=plan.offsets[b], gdims=plan.global_dims,
                own_lo=plan.owned_lo[b], own_hi=plan.owned_hi[b],
            )
        )
    return _merge_triangles(parts)
