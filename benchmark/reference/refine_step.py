"""Plain PyTorch reference of GauSTAR's refine step, in float32 with TF32 off.

One step, on a mesh-bound gaussian model made from the benchmark's inputs
(mesh vertices, faces, vertex colours, the rig, the GT images and depths):

  - SuGaR geometry: 6 gaussians a face at fixed barycentric coordinates,
    rotation from the face frame spun by a complex number, scales
    (thickness, e^s1, e^s2), opacity sigmoid(density), SH colour at degree 2;
  - 3D Gaussian splatting's projection (EWA covariance, +0.3 low-pass, the
    exact anisotropic tile rectangle, opacity and near culls), its depth sort
    and tile lists, and front-to-back compositing (`blend.TileBlend`) of RGB
    and view depth over a green screen at depth 10;
  - the loss stack of GauSTAR's refine (refine.py:584-748 upstream):
    0.8 L1 + 0.2 DSSIM on margin-masked images, 0.1 depth L1 on the
    foreground, 1.0 mask L1 on the background, 0.5 normal consistency,
    1000 edge and 1000 area isometry, relu(0.8 - opacity); a batch of
    cameras takes the mean of the camera terms;
  - autograd, then Adam (0.9, 0.999, eps 1e-15) with named-group learning
    rates, bias correction in float32 and the position schedule evaluated at
    the step count before the step.

It imports nothing of the program under test and takes nothing the program
made: the model, its topology tables and reference lengths and areas, the
cameras' matrices and the margins are worked out here again from the inputs.
`tf32=True` is the control: every matrix product and SSIM's convolutions run
on inputs rounded to TF32's 10-bit mantissa, as tensor cores would.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.blend import TILE, TileBlend

LEAVES = ("points", "scales", "complex2d", "densities", "sh_dc", "sh_rest", "delta_t", "delta_r")

# GauSTAR's refine hyperparameters (RefineConfig defaults upstream).
DSSIM = 0.2
DEPTH_FACTOR = 0.1
MASK_FACTOR = 1.0
MAX_DEPTH = 10.0
NC_FACTOR = 0.5
EDGE_FACTOR = 1000.0
AREA_FACTOR = 1000.0
MIN_OPACITY = 0.8
BG = (0.0, 1.0, 0.0)
# Optimizer (OptimizationParams defaults upstream).
POSITION_LR_INIT = 0.00016
POSITION_LR_FINAL = 0.0000016
POSITION_LR_DELAY_MULT = 0.01
POSITION_LR_MAX_STEPS = 30_000
FEATURE_LR = 0.0025
OPACITY_LR = 0.05
SCALING_LR = 0.005
ROTATION_LR = 0.001
B1, B2, EPS = 0.9, 0.999, 1e-15

SQRT3 = math.sqrt(3.0)
BARY6 = (1.0 / (4.0 + 2.0 * SQRT3), [
    [2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3],
    [1 / 6, 5 / 12, 5 / 12], [5 / 12, 1 / 6, 5 / 12], [5 / 12, 5 / 12, 1 / 6],
])
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)


def round_tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class Reference:
    """The model, its Adam state and the step, from the benchmark's inputs."""

    def __init__(self, scene, config: dict, tf32: bool = False):
        """`config`: the cell's configuration; its "sh_degree" and
        "lr_scale" are read."""
        sh_degree = config["sh_degree"]
        self.scene = scene
        self.sh_degree = sh_degree
        self.tf32 = tf32
        self.count = 0
        dev = scene.verts.device
        verts, faces = scene.verts.float(), scene.faces.long()
        self.faces = faces
        radius, bary = BARY6
        self.bary = torch.tensor(bary, dtype=torch.float32, device=dev)
        ng = len(bary)
        fv = verts[faces]
        edge = torch.linalg.vector_norm(fv - fv[:, [1, 2, 0]], dim=-1)
        s0 = torch.clamp(edge.amin(-1) * radius, min=1e-7)
        n = faces.shape[0] * ng
        colors = (scene.colors[faces][:, None] * self.bary[None, :, :, None]).sum(2).reshape(n, 3)
        op = torch.full((n, 1), 0.1, dtype=torch.float32, device=dev)
        init = {
            "points": verts,
            "scales": torch.log(s0).repeat_interleave(ng)[:, None].repeat(1, 2),
            "complex2d": torch.cat([torch.ones(n, 1, device=dev), torch.zeros(n, 1, device=dev)], 1),
            "densities": torch.log(op / (1.0 - op)),
            "sh_dc": ((colors - 0.5) / SH_C0)[:, None, :],
            "sh_rest": torch.zeros(n, (sh_degree + 1) ** 2 - 1, 3, device=dev),
            "delta_t": torch.zeros(n, 3, device=dev),
            "delta_r": torch.cat([torch.ones(n, 1, device=dev), torch.zeros(n, 3, device=dev)], 1),
        }
        self.leaves = {k: init[k].detach().clone().requires_grad_() for k in LEAVES}
        self.mu = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.edges, self.adj = topology(faces, verts.shape[0])
        with torch.no_grad():
            self.ref_edge = edge_lengths(verts, self.edges)
            self.ref_area = face_areas_normals(verts, faces)[0]
        self.spatial_lr_scale = config["lr_scale"]

    # -- the model --------------------------------------------------------

    def mm(self, a, b):
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def geometry(self):
        """(centres [N, 3], covariance [N, 6]: xx, xy, xz, yy, yz, zz)."""
        p = self.leaves
        fv = p["points"][self.faces]  # [F, 3, 3]
        v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
        centres = (fv[:, None, :, :] * self.bary[None, :, :, None]).sum(2).reshape(-1, 3)
        r0 = normalize(torch.linalg.cross(v1 - v0, v2 - v0))
        b1 = normalize(v0 - v1)
        b2 = normalize(torch.linalg.cross(r0, b1))
        ng = self.bary.shape[0]
        c = p["complex2d"].reshape(-1, ng, 2)
        cn = torch.sqrt(c[..., 0] ** 2 + c[..., 1] ** 2)
        cn = torch.maximum(cn, cn.new_full((), 1e-12))
        ca, cb = (c[..., 0] / cn)[..., None], (c[..., 1] / cn)[..., None]
        r0 = r0[:, None, :].expand(-1, ng, 3)
        r1 = ca * b1[:, None, :] + cb * b2[:, None, :]
        r2 = -cb * b1[:, None, :] + ca * b2[:, None, :]
        plane = torch.exp(p["scales"]).reshape(-1, ng, 2)
        s2 = [torch.full_like(plane[..., 0], 1e-6) ** 2, plane[..., 0] ** 2, plane[..., 1] ** 2]
        cov = [s2[0] * r0[..., d] * r0[..., e] + s2[1] * r1[..., d] * r1[..., e] + s2[2] * r2[..., d] * r2[..., e]
               for d, e in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
        return centres, torch.stack([x.reshape(-1) for x in cov], -1)

    def colours(self, centres, campos):
        """SH colour at the view direction, + 0.5, clamped at 0."""
        p = self.leaves
        sh = torch.cat([p["sh_dc"], p["sh_rest"]], 1)
        d = centres - campos
        sq = (d * d).sum(-1, keepdim=True)
        d = d / torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))
        x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        out = SH_C0 * sh[:, 0]
        if self.sh_degree > 0:
            out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
        if self.sh_degree > 1:
            out = (out + SH_C2[0] * x * y * sh[:, 4] + SH_C2[1] * y * z * sh[:, 5]
                   + SH_C2[2] * (2.0 * z * z - x * x - y * y) * sh[:, 6] + SH_C2[3] * x * z * sh[:, 7]
                   + SH_C2[4] * (x * x - y * y) * sh[:, 8])
        out = out + 0.5
        return torch.maximum(out, out.new_zeros(()))

    def camera(self, i: int):
        """The matrices of camera `i` in float32: view, full projection,
        centre, focal lengths and tan(fov / 2)."""
        rig = self.scene.rig
        dev = self.scene.verts.device
        w2c = torch.as_tensor(rig.w2c[i], dtype=torch.float32, device=dev)
        view = torch.eye(4, device=dev)
        view[:3, :4] = w2c[:3, :4]
        fx = torch.tensor(rig.fx[i], dtype=torch.float32, device=dev)
        fy = torch.tensor(rig.fy[i], dtype=torch.float32, device=dev)
        cx, cy = float(rig.cx[i]), float(rig.cy[i])
        w, h = rig.width, rig.height
        tanx, tany = w / (2.0 * fx), h / (2.0 * fy)
        s = min(w, h) / 2.0
        zn, zf = 0.01, 100.0
        proj = torch.zeros(4, 4, device=dev)
        proj[0, 0], proj[1, 1] = 1.0 / tanx, 1.0 / tany
        proj[0, 2], proj[1, 2] = (cx - w / 2.0) / s, (cy - h / 2.0) / s
        proj[2, 2], proj[2, 3] = zf / (zf - zn), -(zf * zn) / (zf - zn)
        proj[3, 2] = 1.0
        campos = -self.mm(view[:3, :3].T, view[:3, 3:4])[:, 0]
        return view, self.mm(proj, view), campos, w / (2.0 * tanx), h / (2.0 * tany), tanx, tany

    def render(self, i: int, centres, cov):
        """(RGB [3, H, W], depth [H, W], pairs) of camera `i`."""
        rig = self.scene.rig
        w, h = rig.width, rig.height
        view, full, campos, fx, fy, tanx, tany = self.camera(i)
        rgb = self.colours(centres, campos)
        z = self.mm(centres, view[2, :3, None])[:, 0] + view[2, 3]
        feats4 = torch.cat([rgb, z[:, None]], 1)
        opac = torch.sigmoid(self.leaves["densities"].reshape(-1))

        p_view = self.mm(centres, view[:3, :3].T) + view[:3, 3]
        depth = p_view[:, 2]
        p_hom = self.mm(centres, full[:3, :3].T) + full[:3, 3]
        p_w = 1.0 / (self.mm(centres, full[3, :3, None])[:, 0] + full[3, 3] + 1e-7)
        mean2d = torch.stack([((p_hom[:, 0] * p_w + 1.0) * w - 1.0) * 0.5,
                              ((p_hom[:, 1] * p_w + 1.0) * h - 1.0) * 0.5], -1)
        cov2d = self.ewa(centres, cov, view, fx, fy, tanx, tany)
        det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
        det_ok = det != 0.0
        det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
        conic = torch.stack([cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv, cov2d[:, 0] * det_inv], -1)

        gx, gy = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
        with torch.no_grad():
            touched, rect_min, rect_max = tile_rects(mean2d.detach(), cov2d.detach(), det.detach(),
                                                     opac.detach(), depth.detach() > 0.2, det_ok, gx, gy)
            pair_gauss, start, count = tile_lists(depth.detach(), touched, rect_min, rect_max, gx, gx * gy)
        feats = torch.cat([mean2d, conic, opac[:, None], feats4], -1)[pair_gauss]
        out = TileBlend.apply(feats, start, count, gx, w, h, 4)  # [T, 5, 256]
        img = out.reshape(gy, gx, 5, TILE, TILE).permute(2, 0, 3, 1, 4).reshape(5, gy * TILE, gx * TILE)[:, :h, :w]
        bg = torch.tensor([*BG, MAX_DEPTH], dtype=torch.float32, device=img.device)
        img4 = img[:4] + img[4:5] * bg[:, None, None]
        return img4[:3], img4[3], int(pair_gauss.shape[0])

    def ewa(self, means, cov, view, fx, fy, tanx, tany):
        rv, tv = view[:3, :3], view[:3, 3]
        t = self.mm(means, rv.T) + tv
        limx, limy = 1.3 * tanx, 1.3 * tany
        tz = t[:, 2]
        tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
        ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz
        j00, j02 = fx / tz, -(fx * tx) / (tz * tz)
        j11, j12 = fy / tz, -(fy * ty) / (tz * tz)
        u0 = j00[:, None] * rv[0][None] + j02[:, None] * rv[2][None]
        u1 = j11[:, None] * rv[1][None] + j12[:, None] * rv[2][None]
        xx, xy, xz, yy, yz, zz = cov.unbind(-1)

        def sig(v):
            return torch.stack([xx * v[:, 0] + xy * v[:, 1] + xz * v[:, 2],
                                xy * v[:, 0] + yy * v[:, 1] + yz * v[:, 2],
                                xz * v[:, 0] + yz * v[:, 1] + zz * v[:, 2]], -1)

        su0, su1 = sig(u0), sig(u1)
        return torch.stack([(u0 * su0).sum(-1) + 0.3, (u0 * su1).sum(-1), (u1 * su1).sum(-1) + 0.3], -1)

    # -- the loss -----------------------------------------------------------

    def pixel_loss(self, i: int, rgb, depth):
        gt = self.scene.gt_images[i].permute(2, 0, 1)
        gt_depth = self.scene.gt_depths[i]
        h, w = gt_depth.shape
        rig = self.scene.rig
        m = margins(float(rig.cx[i]), float(rig.cy[i]), w, h)
        xs, ys = torch.arange(w, device=gt.device), torch.arange(h, device=gt.device)
        mask = ((ys >= m[2]) & (ys < h - m[3]))[:, None] & ((xs >= m[0]) & (xs < w - m[1]))[None, :]
        mask = mask.to(torch.float32)
        l1 = masked_mean(torch.abs(rgb - gt), mask[None].expand(3, h, w))
        smap = self.ssim_map(rgb * mask, gt * mask)
        ssim = masked_mean(smap, mask[None].expand(3, h, w))
        fg = (gt_depth < MAX_DEPTH).to(torch.float32)
        bg = (gt_depth > MAX_DEPTH).to(torch.float32)
        return ((1.0 - DSSIM) * l1 + DSSIM * (1.0 - ssim)
                + DEPTH_FACTOR * masked_mean(torch.abs(depth - gt_depth), fg)
                + MASK_FACTOR * masked_mean(torch.abs(depth - MAX_DEPTH), bg))

    def ssim_map(self, a, b):
        """SSIM map, 11x11 gaussian window (sigma 1.5), zero padding."""
        x = torch.arange(11, dtype=torch.float64) - 5
        g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
        g = (g / g.sum()).to(torch.float32).to(a.device)
        stack = torch.cat([a, b, a * a, b * b, a * b], 0)[:, None]  # [15, 1, H, W]
        kh, kw = g.reshape(1, 1, 11, 1), g.reshape(1, 1, 1, 11)
        if self.tf32:
            out = F.conv2d(round_tf32(stack), round_tf32(kh), padding=(5, 0))
            out = F.conv2d(round_tf32(out), round_tf32(kw), padding=(0, 5))[:, 0]
        else:
            out = F.conv2d(F.conv2d(stack, kh, padding=(5, 0)), kw, padding=(0, 5))[:, 0]
        mu1, mu2, e11, e22, e12 = out.split(3)
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
        return ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))

    def shared_loss(self):
        p = self.leaves
        verts = p["points"]
        area, normals = face_areas_normals(verts, self.faces)
        nc = (1.0 - (normals[self.adj[:, 0]] * normals[self.adj[:, 1]]).sum(-1)).mean()
        edge = ((edge_lengths(verts, self.edges) - self.ref_edge) ** 2).mean()
        area_l = torch.abs(area - self.ref_area).mean()
        op_reg = torch.relu(MIN_OPACITY - torch.sigmoid(p["densities"].reshape(-1))).mean()
        return NC_FACTOR * nc + EDGE_FACTOR * edge + AREA_FACTOR * area_l + op_reg

    # -- the step -----------------------------------------------------------

    def step(self, cams) -> tuple[float, dict]:
        """One step over the camera indices `cams`: (loss, gradients)."""
        centres, cov = self.geometry()
        pixel = [self.pixel_loss(i, *self.render(i, centres, cov)[:2]) for i in cams]
        loss = sum(pixel) / len(pixel) + self.shared_loss()
        names = list(LEAVES)
        gs = torch.autograd.grad(loss, [self.leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.leaves[k]) if g is None else g for k, g in zip(names, gs)}
        self.adam(grads)
        return float(loss.detach()), grads

    @torch.no_grad()
    def adam(self, grads):
        lrs = self.learning_rates(self.count)
        self.count += 1
        bc1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** self.count)
        bc2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** self.count)
        for k, p in self.leaves.items():
            g = grads[k]
            self.mu[k].mul_(B1).add_((1.0 - B1) * g)
            self.nu[k].mul_(B2).add_((1.0 - B2) * (g * g))
            p.add_((self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS) * (-lrs[k]))

    def learning_rates(self, count: int) -> dict:
        s = self.spatial_lr_scale
        return {"points": position_lr(count, POSITION_LR_INIT * s, POSITION_LR_FINAL * s),
                "scales": SCALING_LR, "complex2d": ROTATION_LR, "densities": OPACITY_LR,
                "sh_dc": FEATURE_LR, "sh_rest": FEATURE_LR / 20.0,
                "delta_t": POSITION_LR_INIT * s, "delta_r": ROTATION_LR}


def position_lr(step: int, lr_init: float, lr_final: float) -> float:
    """The exponential position schedule in float32 (no delay steps)."""
    f32 = torch.float32
    t = min(max(step / POSITION_LR_MAX_STEPS, 0.0), 1.0)
    t = torch.tensor(t, dtype=f32)
    lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1.0 - t)
                     + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    return float(lerp)


def normalize(v):
    sq = (v * v).sum(-1, keepdim=True)
    return v / torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))


def face_areas_normals(verts, faces):
    fv = verts[faces]
    n = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    nn = torch.sqrt(torch.maximum((n * n).sum(-1), n.new_full((), 1e-24)))
    return 0.5 * nn, n / nn[:, None]


def edge_lengths(verts, edges):
    d = verts[edges[:, 0]] - verts[edges[:, 1]]
    return torch.sqrt(torch.maximum((d * d).sum(-1), d.new_full((), 1e-24)))


def topology(faces, n_verts: int):
    """(unique edges [E, 2], face pairs sharing an edge [E_int, 2])."""
    he = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    fid = torch.arange(faces.shape[0], device=faces.device).repeat(3)
    key = torch.minimum(he[:, 0], he[:, 1]) * n_verts + torch.maximum(he[:, 0], he[:, 1])
    key, order = torch.sort(key, stable=True)
    fid = fid[order]
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    edges = torch.stack([uniq // n_verts, uniq % n_verts], 1)
    first = torch.cumsum(counts, 0) - counts
    inner = first[counts == 2]
    return edges, torch.stack([fid[inner], fid[inner + 1]], 1)


def margins(cx: float, cy: float, width: int, height: int):
    """Crop margins (left, right, top, bottom) from the principal point."""
    m = [1, 1, 1, 1]
    if cx < width / 2:
        m[0] = int(width / 2 - cx) + 1
    else:
        m[1] = int(cx - width / 2) + 1
    if cy < height / 2:
        m[2] = int(height / 2 - cy) + 1
    else:
        m[3] = int(cy - height / 2) + 1
    return m


def masked_mean(x, mask):
    return (x * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def tile_rects(mean2d, cov2d, det, opac, in_front, det_ok, gx: int, gy: int):
    """(tiles touched [N], rect min, rect max [N, 2]): 3-sigma radius cut
    to where alpha can reach 1/255 on each axis; culled gaussians touch 0."""
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    two_l = 2.0 * torch.log(torch.clamp_min(opac, 1.0 / 255.0) * 255.0)
    rx = torch.minimum(radius, torch.ceil(torch.sqrt(torch.clamp_min(two_l * cov2d[:, 0], 0.0))))
    ry = torch.minimum(radius, torch.ceil(torch.sqrt(torch.clamp_min(two_l * cov2d[:, 2], 0.0))))
    x, y = mean2d[:, 0], mean2d[:, 1]
    x0 = torch.clamp(((x - rx) / TILE).to(torch.int32), 0, gx)
    y0 = torch.clamp(((y - ry) / TILE).to(torch.int32), 0, gy)
    x1 = torch.clamp(torch.minimum(((x + radius + TILE - 1) / TILE).to(torch.int32),
                                   ((x + rx + TILE) / TILE).to(torch.int32)), 0, gx)
    y1 = torch.clamp(torch.minimum(((y + radius + TILE - 1) / TILE).to(torch.int32),
                                   ((y + ry + TILE) / TILE).to(torch.int32)), 0, gy)
    touched = (x1 - x0) * (y1 - y0)
    alive = in_front & det_ok & (touched > 0) & (opac >= 1.0 / 255.0)
    touched = torch.where(alive, touched, torch.zeros_like(touched)).to(torch.int64)
    return touched, torch.stack([x0, y0], -1).long(), torch.stack([x1, y1], -1).long()


def tile_lists(depth, touched, rect_min, rect_max, gx: int, n_tiles: int):
    """(gaussian of each pair [P], tile start [T], tile count [T]): every
    gaussian emits the tiles of its rectangle; each tile's list is in
    (culled, depth) order, ties by index."""
    dev = depth.device
    by_depth = torch.sort(depth, stable=True).indices
    order = by_depth[torch.sort((touched[by_depth] == 0).to(torch.int8), stable=True).indices]
    t = touched[order]
    n_pairs = int(t.sum())
    gi = torch.repeat_interleave(torch.arange(t.shape[0], device=dev), t, output_size=n_pairs)
    k = torch.arange(n_pairs, device=dev) - (torch.cumsum(t, 0) - t)[gi]
    rmin = rect_min[order][gi]
    rw = (rect_max[:, 0] - rect_min[:, 0])[order][gi]
    dy = torch.div(k, rw, rounding_mode="floor")
    tile = (rmin[:, 1] + dy) * gx + rmin[:, 0] + (k - dy * rw)
    tile, perm = torch.sort(tile, stable=True)
    count = torch.bincount(tile, minlength=n_tiles)
    start = torch.cumsum(count, 0) - count
    return order[gi[perm]], start, count

