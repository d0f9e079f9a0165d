"""Spherical harmonics evaluation (counterpart of gaustar_tpu/ops/sh.py).

The real SH basis of 3D Gaussian splatting. Coefficient layout sh[..., K, C]
with K = (deg+1)**2 bands (dc first). The SH warmup truncates the degree
statically: PyTorch runs eagerly, so the JAX package's traced per-degree
weights (`eval_sh_soa_banded`), which give identical values and gradients, are
not needed here.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions. sh: [..., K, C]; dirs: [..., 3] -> [..., C]."""
    if not 0 <= deg <= 4 or sh.shape[-2] < num_sh_coeffs(deg):
        raise ValueError(f"eval_sh: degree {deg} needs {num_sh_coeffs(deg)} bands, got {sh.shape[-2]}")
    result = C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :] - C1 * x * sh[..., 3, :]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4, :]
                + C2[1] * yz * sh[..., 5, :]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + C2[3] * xz * sh[..., 7, :]
                + C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + C3[1] * xy * z * sh[..., 10, :]
                    + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * sh[..., 16, :]
                        + C4[1] * yz * (3.0 * xx - yy) * sh[..., 17, :]
                        + C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18, :]
                        + C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19, :]
                        + C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * sh[..., 20, :]
                        + C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21, :]
                        + C4[6] * (xx - yy) * (7.0 * zz - 1.0) * sh[..., 22, :]
                        + C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23, :]
                        + C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)) * sh[..., 24, :]
                    )
    return result


def _basis_terms(deg: int, x, y, z):
    """SH basis polynomials as a flat list of [N] tensors with their signs
    folded in, band order matching eval_sh (band 0 is C0, handled directly)."""
    terms = [None]
    if deg > 0:
        terms += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            terms += [
                C2[0] * x * y,
                C2[1] * y * z,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * x * z,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                terms += [
                    C3[0] * y * (3.0 * xx - yy),
                    C3[1] * x * y * z,
                    C3[2] * y * (4.0 * zz - xx - yy),
                    C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    C3[4] * x * (4.0 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3.0 * yy),
                ]
                if deg > 3:
                    terms += [
                        C4[0] * x * y * (xx - yy),
                        C4[1] * y * z * (3.0 * xx - yy),
                        C4[2] * x * y * (7.0 * zz - 1.0),
                        C4[3] * y * z * (7.0 * zz - 3.0),
                        C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                        C4[5] * x * z * (7.0 * zz - 3.0),
                        C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                        C4[7] * x * z * (xx - 3.0 * yy),
                        C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
                    ]
    return terms


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """The real SH basis of bands 0..deg at unit directions, in eval_sh's band
    order and signs: dirs [N, 3] -> [N, (deg+1)**2]. At deg 3 these are the
    16 values of tiny-cuda-nn's degree-4 SphericalHarmonics encoding."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    terms = _basis_terms(deg, x, y, z)
    terms[0] = torch.full_like(x, C0)
    return torch.stack(terms, dim=-1)


def sh_to_rgb(deg: int, sh: torch.Tensor, positions: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """Rasterizer-style SH color (computeColorFromSH, forward.cu:20-71): eval at
    the view direction, +0.5, clamp >= 0. sh [N, K, C] -> [N, C].

    Component-major like the JAX package (one [C, N] accumulator per band), so
    the sums run in the same order. `torch.maximum` splits the gradient at a
    tie as JAX's maximum does."""
    d = positions - campos
    # max INSIDE the sqrt: grad-safe at d == 0 (see utils.general.l2norm)
    sq = d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2
    inv = 1.0 / torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))
    x, y, z = d[:, 0] * inv, d[:, 1] * inv, d[:, 2] * inv
    k = num_sh_coeffs(deg)
    sh_t = sh.permute(1, 2, 0)  # [K, C, N]
    terms = _basis_terms(deg, x, y, z)
    out = C0 * sh_t[0]
    for band in range(1, k):
        out = out + terms[band] * sh_t[band]
    out = out.T + 0.5
    return torch.maximum(out, out.new_zeros(()))


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb_dc(sh):
    return sh * C0 + 0.5
