"""Plain PyTorch reference of the mesh initializer's field step, in float32
with TF32 off: Instant-NGP's hash-grid NeRF (Müller et al. 2022,
arXiv:2201.05989, §3-4 and Table 1) trained on rays of several cameras with
HumanRF's sampler (data_process/humanrf's ray_sampler and occupancy grid).

  - Occupancy: the visual hull carved from the masks. A cell of the G^3 grid
    over the AABB stays occupied where its centre projects into the mask of
    every camera that sees it (in front, inside the image); then rounds of
    3^3 dilation.
  - Rays through pixel centres (x + 0.5, y + 0.5) of the step's cameras, the
    pixels and the jitter drawn by benchmark/field_rays.py; GT colour and
    mask (depth < the GT's miss) at each pixel.
  - Sampling: each ray's slab through the AABB (the slab test on the
    direction's reciprocal; tmin >= 1e-3, tmax >= tmin + 1e-3), tightened to
    its occupied span by a coarse march of 64 nearest-cell lookups at step
    centres and 5 bisection steps at each end (a ray that meets no occupied
    cell collapses to [tmin, tmin]); then S samples, one in each of S equal
    steps at its jitter.
  - Encoding: level l has N_l = floor(N_min b^l), b = exp(ln(N_max / N_min) /
    (L - 1)) in float64 (at the published widths b^15 rounds below 128, so
    the finest level reads 2047); its corner rows are x + y (N_l + 1) + z
    (N_l + 1)^2 where (N_l + 1)^3 <= T, else (x 1 xor y 2654435761 xor z
    805459861) mod T in 32-bit arithmetic, either modulo T (which only moves
    the zero-weight corners of points on the far faces); features are the
    trilinear sums of the 8 corners' F-wide rows.
  - Density net L F -> 64 -> 16 (ReLU), output 0 the log-density; colour net
    on those 16 outputs and the direction's 16 real SH values (bands 0-3)
    -> 64 -> 64 -> 3, sigmoid.
  - Compositing: alpha = 1 - exp(-sigma delta), transmittance the exclusive
    product of (1 - alpha + 1e-10), weights alpha T.
  - Loss: mean((rgb - gt)^2 mask) + w mean((acc - mask)^2); autograd;
    torch.optim.Adam with the configuration's lr, betas (0.9, 0.99) and eps
    (1e-15), as HumanRF's trainer makes it.

Rounding: each corner's weight is (w_x w_y) w_z, and the tables' gradient
is summed in float64 and rounded once to float32, so that a sound program,
which does the same, keeps this state bit for bit through the check steps
(but for rare ties). With eps at 1e-15 Adam moves an element by about the
learning rate whatever its gradient's size, so a gradient element within
rounding of zero that takes the other sign moves a small leaf's change by
about 1e-4 of its norm: float32 sums in another order made sound runs read
so (PERF.md §2).

Departures from the paper, each the port's: sigma = exp(clamp(log-density,
-10, 10)) x a density scale; HumanRF's uniform sampler between tightened
bounds in place of NGP's occupancy marching with exponential steps; no L2
weight decay on the MLPs; the 1e-10 guard in the transmittance.

It imports nothing of the program under test and takes nothing the program
made: the cameras, masks, occupancy and indices are worked out here again
from the inputs. `tf32=True` is the control: every matrix product, forward
and backward, runs on inputs rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import field_rays
from benchmark.reference.refine_step import round_tf32

PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF
N_COARSE, N_BISECT = 64, 5
SH_C = (0.28209479177387814, 0.4886025119029199, 1.0925484305920792, 0.31539156525252005, 0.5462742152960396,
        0.5900435899266435, 2.890611442640554, 0.4570457994644658, 0.3731763325901154, 1.445305721320277)


def level_resolutions(n_levels: int, n_min: int, n_max: int) -> list:
    b = math.exp(math.log(n_max / n_min) / (n_levels - 1)) if n_levels > 1 else 1.0
    return [math.floor(n_min * b**lvl) for lvl in range(n_levels)]


def corner_rows(pts01, res: int, table_size: int, dense: bool):
    """(rows [N, 8] int64, trilinear weights [N, 8]) of each point's cell
    corners at one level, corner k at offset (k & 1, k >> 1 & 1, k >> 2 & 1)."""
    x = pts01 * res
    x0 = torch.floor(x)
    f = x - x0
    c0 = x0.to(torch.int64)
    rows, weights = [], []
    for k in range(8):
        o = (k & 1, (k >> 1) & 1, (k >> 2) & 1)
        c = [c0[:, a] + o[a] for a in range(3)]
        w = [f[:, a] if o[a] else 1.0 - f[:, a] for a in range(3)]
        if dense:
            r = c[0] + (res + 1) * c[1] + (res + 1) ** 2 * c[2]
        else:
            r = ((c[0] * PRIMES[0]) & MASK32) ^ ((c[1] * PRIMES[1]) & MASK32) ^ ((c[2] * PRIMES[2]) & MASK32)
        rows.append(r % table_size)
        weights.append(w[0] * w[1] * w[2])
    return torch.stack(rows, -1), torch.stack(weights, -1)


def sh16(d):
    """The 16 real SH values of bands 0-3 at unit directions d [N, 3]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    c = SH_C
    return torch.stack([
        torch.full_like(x, c[0]), -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * x * y, -c[2] * y * z, c[3] * (2.0 * zz - xx - yy), -c[2] * x * z, c[4] * (xx - yy),
        -c[5] * y * (3.0 * xx - yy), c[6] * x * y * z, -c[7] * y * (4.0 * zz - xx - yy),
        c[8] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), -c[7] * x * (4.0 * zz - xx - yy), c[9] * z * (xx - yy),
        -c[5] * x * (xx - 3.0 * yy)], -1)


class _Gather(torch.autograd.Function):
    """table[rows], its backward summed in float64 and rounded once."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.n_rows = table.shape[0]
        return table[rows]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        out = torch.zeros((ctx.n_rows, g.shape[-1]), dtype=torch.float64, device=g.device)
        out.index_add_(0, rows.reshape(-1), g.reshape(-1, g.shape[-1]).double())
        return out.float(), None


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


class Reference:
    """The field, its Adam state and the step, from the benchmark's inputs."""

    def __init__(self, scene, config: dict, tf32: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.tf32 = tf32
        self.count = 0
        f, t = config["field"], config["train"]
        self.f, self.t = f, t
        dev = scene.gt_images.device
        self.dev = dev
        self.res = level_resolutions(f["n_levels"], f["base_res"], f["max_res"])
        self.dense = [(r + 1) ** 3 <= f["table_size"] for r in self.res]
        self.lo = torch.tensor(f["aabb_min"], dtype=torch.float32, device=dev)
        self.hi = torch.tensor(f["aabb_max"], dtype=torch.float32, device=dev)
        rig = scene.rig
        self.height = rig.height
        self.rot = torch.as_tensor(rig.w2c[:, :3, :3], dtype=torch.float32, device=dev)
        self.trans = torch.as_tensor(rig.w2c[:, :3, 3], dtype=torch.float32, device=dev)
        rot_t = torch.as_tensor(np.ascontiguousarray(rig.w2c[:, :3, :3].transpose(0, 2, 1)), dtype=torch.float32,
                                device=dev)
        self.eye = torch.stack([-(r @ t) for r, t in zip(rot_t, self.trans)])  # the centres, -R^T t
        # Cameras carried by their field of view, as 3D Gaussian splatting's
        # (and benchmark/reference/refine_step.py's): tan(fov / 2) = W / (2 f),
        # and the focal length W / (2 tan(fov / 2)) again.
        fx, fy, cx, cy = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (rig.fx, rig.fy, rig.cx, rig.cy))
        tanx, tany = rig.width / (2.0 * fx), rig.height / (2.0 * fy)
        self.intr = [rig.width / (2.0 * tanx), rig.height / (2.0 * tany), cx, cy]
        self.images = scene.gt_images
        self.masks = (scene.gt_depths < config["gt"]["miss"]).to(torch.float32)
        self.occ = self.carve(t["occupancy_res"], t["occupancy_dilate"])
        self.fg = field_rays.foreground(self.masks)
        w = field_rays.initial_weights(config, scene, dev)
        params = {"tables": w["tables"]}
        for net in ("sigma", "color"):
            for i, (wi, bi) in enumerate(w[net]):
                params[f"{net}.w{i}"], params[f"{net}.b{i}"] = wi, bi
        self.params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"])
        self.leaves = self.split({k: v.detach() for k, v in self.params.items()})

    @property
    def mu(self) -> dict:
        """Adam's first moments, split as the leaves."""
        return self.split({k: self.opt.state[p].get("exp_avg", torch.zeros_like(p)) for k, p in self.params.items()})

    def split(self, tensors: dict) -> dict:
        """{leaf: tensor}, the tables one leaf a level (views)."""
        out = {f"tables.l{lvl:02d}": tensors["tables"][lvl] for lvl in range(self.f["n_levels"])}
        out.update((k, v) for k, v in tensors.items() if k != "tables")
        return out

    # -- the sampler --------------------------------------------------------

    def project(self, c: int, pts):
        """(x, y, z) of world points [N, 3] in camera c's pixels and depth."""
        cam = pts @ self.rot[c].T + self.trans[c]
        z = cam[:, 2]
        zc = torch.clamp_min(z, 1e-6)
        fx, fy, cx, cy = (a[c] for a in self.intr)
        return cam[:, 0] / zc * fx + cx, cam[:, 1] / zc * fy + cy, z

    @torch.no_grad()
    def carve(self, g: int, dilate: int):
        """The visual hull [g, g, g] (1 / 0) over the AABB, dilated."""
        i = torch.arange(g, dtype=torch.float64, device=self.dev) + 0.5
        lo, hi = self.lo.double(), self.hi.double()
        axes = [(lo[a] + i * (hi[a] - lo[a]) / g).float() for a in range(3)]
        centres = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        occ = torch.ones(centres.shape[0], dtype=torch.bool, device=self.dev)
        h, w = self.masks.shape[1:]
        for c in range(self.masks.shape[0]):
            x, y, z = self.project(c, centres)
            seen = (z > 1e-3) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
            inside = self.masks[c][torch.clamp(y.long(), 0, h - 1), torch.clamp(x.long(), 0, w - 1)] > 0.5
            occ &= inside | ~seen
        grid = occ.reshape(g, g, g).float()
        for _ in range(dilate):
            grid = F.max_pool3d(grid[None, None], 3, stride=1, padding=1)[0, 0]
        return grid

    def occupied(self, pts):
        """Nearest-cell occupancy at points [..., 3] (False outside the AABB)."""
        g = self.occ.shape[0]
        u = (pts - self.lo) / (self.hi - self.lo)
        i = torch.clamp((u * g).long(), 0, g - 1)
        inside = ((u >= 0) & (u < 1)).all(-1)
        return inside & (self.occ[i[..., 0], i[..., 1], i[..., 2]] > 0.5)

    @torch.no_grad()
    def bounds(self, o, d):
        """Each ray's [tmin, tmax]: the AABB slab tightened to the occupied span."""
        inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t0, t1 = (self.lo - o) * inv, (self.hi - o) * inv
        tmin = torch.clamp_min(torch.minimum(t0, t1).amax(-1), 1e-3)
        tmax = torch.maximum(torch.maximum(t0, t1).amin(-1), tmin + 1e-3)
        step = (tmax - tmin) / N_COARSE
        k = torch.arange(N_COARSE, device=o.device)
        frac = (k.float() + 0.5) / N_COARSE
        ts = tmin[:, None] + frac * (tmax - tmin)[:, None]
        hit = self.occupied(o[:, None] + d[:, None] * ts[..., None])
        first = torch.where(hit, k, N_COARSE).amin(-1)
        last = torch.where(hit, k, -1).amax(-1)

        def t_at(j):
            return tmin + (j.float() + 0.5) * step

        lo_f, hi_f = t_at(torch.clamp_min(first - 1, 0)), t_at(first)
        lo_b, hi_b = t_at(last), t_at(torch.clamp_max(last + 1, N_COARSE - 1))
        for _ in range(N_BISECT):
            mid = 0.5 * (lo_f + hi_f)
            occ = self.occupied(o + d * mid[:, None])
            lo_f, hi_f = torch.where(occ, lo_f, mid), torch.where(occ, mid, hi_f)
            mid = 0.5 * (lo_b + hi_b)
            occ = self.occupied(o + d * mid[:, None])
            lo_b, hi_b = torch.where(occ, mid, lo_b), torch.where(occ, hi_b, mid)
        any_hit = hit.any(-1)
        new_min = torch.where(any_hit, torch.maximum(lo_f, tmin), tmin)
        new_max = torch.where(any_hit, torch.minimum(hi_b, tmax), tmin)
        return new_min, torch.maximum(new_max, new_min)

    def rays(self, cams, px, py):
        """(origins, unit directions) [K n, 3] through the pixel centres."""
        os, ds = [], []
        for j, c in enumerate(cams):
            fx, fy, cx, cy = (a[c] for a in self.intr)
            local = torch.stack([(px[j].float() + 0.5 - cx) / fx, (py[j].float() + 0.5 - cy) / fy,
                                 torch.ones(px.shape[1], device=px.device)], -1)
            world = local @ self.rot[c]  # R^T v, rows
            ds.append(world / torch.sqrt((world * world).sum(-1, keepdim=True)))
            os.append(self.eye[c].expand(px.shape[1], 3))
        return torch.cat(os), torch.cat(ds)

    # -- the field --------------------------------------------------------

    def mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.tf32 else a @ b

    def mlp(self, net: str, x, n_layers: int):
        p = self.params
        for i in range(n_layers):
            x = self.mm(x, p[f"{net}.w{i}"]) + p[f"{net}.b{i}"]
            if i < n_layers - 1:
                x = torch.relu(x)
        return x

    def encode(self, pts01):
        f = self.f
        feats = []
        for lvl, (res, dense) in enumerate(zip(self.res, self.dense)):
            rows, w = corner_rows(pts01, res, f["table_size"], dense)
            feats.append((_Gather.apply(self.params["tables"][lvl], rows) * w[..., None]).sum(1))
        return torch.cat(feats, -1)

    def step(self, cams) -> tuple[float, dict]:
        """One step over the camera indices `cams`: (loss, gradients)."""
        f, t = self.f, self.t
        self.count += 1
        s = f["n_samples"]
        px, py, jitter = field_rays.draw(self.fg, cams, self.count, t["rays_per_batch"] // len(cams), s,
                                         self.height, self.dev)
        o, d = self.rays(cams, px, py)
        gt = torch.cat([self.images[c][py[j], px[j]] for j, c in enumerate(cams)])
        gm = torch.cat([self.masks[c][py[j], px[j]] for j, c in enumerate(cams)])
        tmin, tmax = self.bounds(o, d)
        frac = (torch.arange(s, dtype=torch.float32, device=o.device) + 0.5) / s + (jitter - 0.5) / s
        ts = tmin[:, None] + frac * (tmax - tmin)[:, None]
        delta = (tmax - tmin)[:, None] / s
        pts = (o[:, None] + d[:, None] * ts[..., None]).reshape(-1, 3)
        u = (pts - self.lo) / (self.hi - self.lo)
        inside = ((u >= 0) & (u <= 1)).all(-1)
        out = self.mlp("sigma", self.encode(torch.clamp(u, 0.0, 1.0)), 2)
        sigma = torch.exp(torch.clamp(out[:, 0], -10.0, 10.0)) * f["density_scale"]
        sigma = torch.where(inside, sigma, torch.zeros_like(sigma)).reshape(ts.shape)
        dirs = sh16(d)[:, None].expand(-1, s, -1).reshape(-1, 16)
        rgb = torch.sigmoid(self.mlp("color", torch.cat([out, dirs], -1), 3)).reshape(*ts.shape, 3)
        alpha = 1.0 - torch.exp(-sigma * delta)
        trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        wts = alpha * trans
        colour = (wts[..., None] * rgb).sum(1)
        acc = wts.sum(1)
        loss = ((colour - gt) ** 2 * gm[:, None]).mean() + t["mask_loss_weight"] * ((acc - gm) ** 2).mean()
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(loss, [self.params[k] for k in names])))
        for k, p in self.params.items():
            p.grad = grads[k]
        self.opt.step()
        return float(loss.detach()), self.split(grads)
