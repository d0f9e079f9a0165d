"""RAFT optical flow (counterpart of gaustar_tpu/tools/raft.py;
data_process/RAFT/core/{raft,extractor,corr,update}.py).

The "basic" RAFT (hidden 128, context 128, 4 correlation levels, radius 4)
that demo_GauSTAR.py runs to produce the bidirectional `flow_bi` inputs, as
an nn.Module whose state-dict keys are the reference's torch names
(`fnet.conv1.weight`, `update_block.mask.0.weight`, ...), the keys the JAX
package's parameter dict uses. A published raft-things.pth therefore loads
with `load_torch_checkpoint` (DataParallel `module.` prefixes stripped; the
`num_batches_tracked` counters and the `downsample.1` aliases of `norm3`
that torch writes are accepted, every other key is held strictly).

Convolutions, instance and eval-mode batch norms and the correlation matmul
are PyTorch's own calls, as the JAX package computes all of them outside any
Pallas kernel. `raft_forward` pins them to float32: cuDNN would otherwise run
the convolutions in TF32 on the H100. The correlation lookup's bilinear
sampler gathers the four taps itself with the reference's zero padding
(utils.bilinear_sampler), so pyramid levels of one or no pixel, which the
JAX package samples as zeros, stay defined.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaustar_tpu_torch.tools.geometry import resize_linear
from gaustar_tpu_torch.utils.general import full_float32, resolve_device

# ---------------------------------------------------------------------------
# Modules (extractor.py, update.py), laid out so that state_dict() has the
# reference's keys and nothing else
# ---------------------------------------------------------------------------


class _BatchNormEval(nn.Module):
    """Eval-mode BatchNorm2d without the num_batches_tracked counter."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, training=False, eps=1e-5)


def _norm(kind: str, c: int) -> nn.Module:
    return nn.InstanceNorm2d(c) if kind == "instance" else _BatchNormEval(c)


class _ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kind: str, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1, self.norm2 = _norm(kind, cout), _norm(kind, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            # The reference's Sequential(conv, norm3) registers norm3 twice
            # (downsample.1); here it is held once, as norm3.
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride))
            self.norm3 = _norm(kind, cout)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        sc = x if self.downsample is None else self.norm3(self.downsample(x))
        return torch.relu(y + sc)


class _BasicEncoder(nn.Module):
    """conv7 s2 -> residual layers 64 / 96 / 128 -> conv1 to 256."""

    def __init__(self, kind: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(kind, 64)
        self.layer1 = nn.Sequential(_ResidualBlock(64, 64, kind, 1), _ResidualBlock(64, 64, kind, 1))
        self.layer2 = nn.Sequential(_ResidualBlock(64, 96, kind, 2), _ResidualBlock(96, 96, kind, 1))
        self.layer3 = nn.Sequential(_ResidualBlock(96, 128, kind, 2), _ResidualBlock(128, 128, kind, 1))
        self.conv2 = nn.Conv2d(128, 256, 1)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(y))))


class _MotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(4 * (2 * 4 + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow, corr):
        co = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        fl = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        return torch.cat([torch.relu(self.conv(torch.cat([co, fl], 1))), flow], 1)


class _SepConvGRU(nn.Module):
    def __init__(self):
        super().__init__()
        for g in "zrq":
            setattr(self, f"conv{g}1", nn.Conv2d(384, 128, (1, 5), padding=(0, 2)))
            setattr(self, f"conv{g}2", nn.Conv2d(384, 128, (5, 1), padding=(2, 0)))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class _FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, h):
        return self.conv2(torch.relu(self.conv1(h)))


class _UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _MotionEncoder()
        self.gru = _SepConvGRU()
        self.flow_head = _FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class RAFT(nn.Module):
    """The basic RAFT. Build it with `make_raft` or `load_torch_checkpoint`;
    call it as `raft_forward(model, image1, image2, iters)`."""

    def __init__(self):
        super().__init__()
        self.fnet = _BasicEncoder("instance")
        self.cnet = _BasicEncoder("batch")
        self.update_block = _UpdateBlock()

    def forward(self, image1, image2, iters: int = 20):
        return raft_forward(self, image1, image2, iters)


# ---------------------------------------------------------------------------
# Correlation pyramid (corr.py CorrBlock)
# ---------------------------------------------------------------------------


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    b, d, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, d, h * w).transpose(1, 2), fmap2.reshape(b, d, h * w)) / float(np.sqrt(d))
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        # 2x2 mean, odd rows and columns dropped; unlike avg_pool2d it takes
        # a level of one pixel to an empty one, as the JAX package does.
        h, w = h // 2, w // 2
        c = corr[..., : 2 * h, : 2 * w]
        corr = (c[..., 0::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 0::2] + c[..., 1::2, 1::2]) / 4.0
        pyramid.append(corr)
    return pyramid


def bilinear_sampler(img, coords):
    """img [N, C, H, W], coords [N, Hc, Wc, 2] (x, y pixel coordinates) ->
    [N, C, Hc, Wc]; taps outside the image read zero."""
    n, c, h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[:, None], (y - y0)[:, None]
    flat = img.reshape(n, c, h * w)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (torch.clamp(yi, 0, max(h - 1, 0)) * w + torch.clamp(xi, 0, max(w - 1, 0))).to(torch.int64)
        if h * w == 0:
            return img.new_zeros((n, c) + tuple(xi.shape[1:]))
        out = torch.gather(flat, 2, idx.reshape(n, 1, -1).expand(n, c, -1)).reshape(n, c, *xi.shape[1:])
        return out * valid[:, None].to(img.dtype)

    return (tap(x0, y0) * (1 - dx) * (1 - dy) + tap(x0 + 1, y0) * dx * (1 - dy)
            + tap(x0, y0 + 1) * (1 - dx) * dy + tap(x0 + 1, y0 + 1) * dx * dy)


def corr_lookup(pyramid, coords, radius: int = 4):
    """coords [B, 2, H, W] -> correlation features [B, levels (2r+1)^2, H, W].
    The window's offsets are (dx, dy) = (j - r, i - r) at (i, j), the JAX
    package's order."""
    b, _, h, w = coords.shape
    r = radius
    ar = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    di, dj = torch.meshgrid(ar, ar, indexing="ij")
    delta = torch.stack([dj, di], dim=-1)  # [2r+1, 2r+1, 2] (dx, dy)
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    out = [bilinear_sampler(corr, centroid / 2**lvl + delta[None]).reshape(b, h, w, -1)
           for lvl, corr in enumerate(pyramid)]
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# RAFT forward
# ---------------------------------------------------------------------------


def coords_grid(b: int, h: int, w: int, device):
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y])[None].expand(b, 2, h, w)


def upsample_flow_convex(flow, mask):
    """8x convex upsampling (raft.py upsample_flow): mask [B, 64*9, H, W]."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    pad = F.pad(8.0 * flow, (1, 1, 1, 1))
    patches = torch.stack([pad[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], dim=2)
    up = (mask * patches[:, :, :, None, None]).sum(dim=2)  # [B, 2, 8, 8, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


@torch.no_grad()
def raft_forward(model: RAFT, image1, image2, iters: int = 20):
    """image1/2 [B, 3, H, W] in [0, 255], H and W divisible by 8 -> the
    full-resolution flow [B, 2, H, W] (x, y displacement)."""
    with full_float32():
        img1 = 2.0 * (image1 / 255.0) - 1.0
        img2 = 2.0 * (image2 / 255.0) - 1.0
        fmap1, fmap2 = model.fnet(img1), model.fnet(img2)
        pyramid = build_corr_pyramid(fmap1, fmap2)
        net, inp = torch.split(model.cnet(img1), 128, dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)

        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, fmap1.device)
        coords1 = coords0.clone()
        flow_up = None
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1)
            net, mask, delta = model.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
            flow_up = upsample_flow_convex(coords1 - coords0, mask)
        return flow_up


# ---------------------------------------------------------------------------
# Parameters and checkpoints
# ---------------------------------------------------------------------------


def make_raft(state_dict: dict, device="cuda") -> RAFT:
    """A RAFT in eval mode on `device` holding `state_dict` (every key of the
    model, nothing else)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = RAFT()
    model = model.to_empty(device=dev)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model.eval()


def clean_state_dict(sd: dict) -> dict:
    """A reference checkpoint's state dict in the port's keys: `module.`
    prefixes stripped, `num_batches_tracked` counters dropped, each
    `downsample.1.*` alias folded into its `norm3.*` (they must be equal)."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if not k.endswith(".num_batches_tracked"):
            out[k] = v
    for k in [k for k in out if ".downsample.1." in k]:
        alias = out.pop(k)
        main = k.replace(".downsample.1.", ".norm3.")
        if main not in out:
            out[main] = alias
        elif not torch.equal(torch.as_tensor(out[main]), torch.as_tensor(alias)):
            raise ValueError(f"{k} differs from {main}, the module it aliases")
    return out


def load_torch_checkpoint(path: str, device="cuda") -> RAFT:
    """A RAFT from a raft-things.pth-layout file (possibly wrapped in
    DataParallel `module.` prefixes, demo_GauSTAR.py:59-62)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return make_raft(clean_state_dict(sd), device)


def random_params(seed: int = 0) -> dict:
    """Random parameters {torch name: float32 array} (architecture tests; NOT
    trained), drawn as the JAX package's random_params draws them."""
    rng = np.random.default_rng(seed)
    p = {}

    def conv(name, o, i, kh, kw):
        p[f"{name}.weight"] = rng.normal(0, 0.05, size=(o, i, kh, kw)).astype(np.float32)
        p[f"{name}.bias"] = np.zeros((o,), np.float32)

    def bn(name, c):
        p[f"{name}.weight"] = np.ones((c,), np.float32)
        p[f"{name}.bias"] = np.zeros((c,), np.float32)
        p[f"{name}.running_mean"] = np.zeros((c,), np.float32)
        p[f"{name}.running_var"] = np.ones((c,), np.float32)

    for prefix, kind, out_dim in [("fnet", "instance", 256), ("cnet", "batch", 256)]:
        conv(f"{prefix}.conv1", 64, 3, 7, 7)
        if kind == "batch":
            bn(f"{prefix}.norm1", 64)
        for li, (cin, cout, stride) in enumerate([(64, 64, 1), (64, 96, 2), (96, 128, 2)], start=1):
            for bi in range(2):
                cin_b = cin if bi == 0 else cout
                st = stride if bi == 0 else 1
                pre = f"{prefix}.layer{li}.{bi}"
                conv(f"{pre}.conv1", cout, cin_b, 3, 3)
                conv(f"{pre}.conv2", cout, cout, 3, 3)
                if kind == "batch":
                    bn(f"{pre}.norm1", cout)
                    bn(f"{pre}.norm2", cout)
                if st != 1 or cin_b != cout:
                    conv(f"{pre}.downsample.0", cout, cin_b, 1, 1)
                    if kind == "batch":
                        bn(f"{pre}.norm3", cout)
        conv(f"{prefix}.conv2", out_dim, 128, 1, 1)

    conv("update_block.encoder.convc1", 256, 4 * (2 * 4 + 1) ** 2, 1, 1)
    conv("update_block.encoder.convc2", 192, 256, 3, 3)
    conv("update_block.encoder.convf1", 128, 2, 7, 7)
    conv("update_block.encoder.convf2", 64, 128, 3, 3)
    conv("update_block.encoder.conv", 126, 256, 3, 3)
    for g in ["z", "r", "q"]:
        conv(f"update_block.gru.conv{g}1", 128, 128 + 256, 1, 5)
        conv(f"update_block.gru.conv{g}2", 128, 128 + 256, 5, 1)
    conv("update_block.flow_head.conv1", 256, 128, 3, 3)
    conv("update_block.flow_head.conv2", 2, 256, 3, 3)
    conv("update_block.mask.0", 256, 128, 3, 3)
    conv("update_block.mask.2", 64 * 9, 256, 1, 1)
    return p


def compute_flow_pair(model: RAFT, img1: np.ndarray, img2: np.ndarray, iters: int = 20, scale: float = 0.5):
    """Bidirectional flow at `scale` resolution with /8 padding, the
    demo_GauSTAR.py pipeline (:24, :88-107), on the model's device. The
    frames are resized as cv2.resize (INTER_LINEAR) resizes them
    (tools/geometry.resize_linear). Returns (flow_f, flow_b, pad), flows
    [h, w, 2] numpy in (x, y) order at the scaled resolution."""
    dev = next(model.parameters()).device
    h0, w0 = img1.shape[:2]
    hs, ws = int(h0 * scale), int(w0 * scale)
    ph, pw = (8 - hs % 8) % 8, (8 - ws % 8) % 8
    pad = [ph // 2, ph - ph // 2, pw // 2, pw - pw // 2]

    def prep(img):
        a = np.pad(resize_linear(img, hs, ws), ((pad[0], pad[1]), (pad[2], pad[3]), (0, 0)))
        return torch.as_tensor(a, device=dev).to(torch.float32).permute(2, 0, 1)[None]

    t1, t2 = prep(img1), prep(img2)

    def crop(flow):
        f = flow[0].permute(1, 2, 0).cpu().numpy()
        return f[pad[0]: f.shape[0] - pad[1], pad[2]: f.shape[1] - pad[3]]

    return crop(raft_forward(model, t1, t2, iters)), crop(raft_forward(model, t2, t1, iters)), pad
