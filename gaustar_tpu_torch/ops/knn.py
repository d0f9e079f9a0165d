"""K-nearest-neighbour distances by chunked brute force (counterpart of
gaustar_tpu/ops/knn.py).

Replaces simple-knn's `distCUDA2` (simple_knn.cu:45-221), the mean squared
distance to the 3 nearest neighbours that initializes vanilla 3DGS scales
(gaussian_model.py:134), and pytorch3d's `knn_points`. As in the JAX package,
each chunk of queries takes its squared distances to every point through the
expansion |q|^2 - 2 q.p + |p|^2 and keeps the smallest. The expansion cancels
where points lie far from the origin: at |q| ~ 4 a float32 ulp of |q|^2 is
about 1.9e-6, while neighbours 2.7 mm apart have d^2 ~ 7.5e-6. On 600,000
points of a sphere at z = 4 the JAX package's values have a median error of
9.5% against exact distances, a largest of 1300%, and some are 0 (NVIDIA
H100, PERF.md). So the port takes the same expansion of coordinates
relative to the reference points' centroid, where |q|^2 is the cloud's own
size: distances are translation invariant, and only the rounding changes.

Each chunk is [chunk, N] float32: 1024 queries (the JAX package's default)
against 600,000 points is 2.46 GB; the chunk stays fixed at 1024 rather than
following free memory. The product q.p is summed coordinate by coordinate
into that one buffer, not by a matmul, so no TF32 switch can round it.
`torch.topk` breaks ties in its own order, which may differ from the JAX
package's among equal distances.
"""

from __future__ import annotations

import torch

CHUNK = 1024


def _sq_dists(q: torch.Tensor, ref_t: torch.Tensor, ref_sq: torch.Tensor) -> torch.Tensor:
    """[Q, N] squared distances |q|^2 + |p|^2 - 2 q.p, `ref_t` [D, N]."""
    d = (q**2).sum(-1, keepdim=True) + ref_sq[None, :]
    for i in range(q.shape[1]):
        d.addcmul_(q[:, i:i + 1], ref_t[i:i + 1], value=-2.0)
    return d


@torch.no_grad()
def knn_sq_dists(points: torch.Tensor, k: int = 3, chunk: int = CHUNK) -> torch.Tensor:
    """[N, k] squared distances to the k nearest OTHER points: the k + 1
    smallest of each row with the smallest (the point itself) dropped,
    clamped at 0."""
    points = points - points.mean(dim=0)
    sq, pts_t = (points**2).sum(-1), points.T.contiguous()
    out = []
    for s in range(0, points.shape[0], chunk):
        d = _sq_dists(points[s:s + chunk], pts_t, sq)
        out.append(torch.topk(d, k + 1, dim=1, largest=False, sorted=True).values[:, 1:])
    return torch.clamp_min(torch.cat(out), 0.0)


def dist2_avg3(points: torch.Tensor) -> torch.Tensor:
    """distCUDA2: mean squared distance to the 3 nearest neighbours, [N]."""
    return knn_sq_dists(points, k=3).mean(dim=-1)


@torch.no_grad()
def knn_points(query: torch.Tensor, ref: torch.Tensor, k: int, chunk: int = CHUNK):
    """pytorch3d.ops.knn_points: (squared distances [Q, k] clamped at 0,
    indices [Q, k] int64), nearest first."""
    centre = ref.mean(dim=0)
    query, ref = query - centre, ref - centre
    sq, ref_t = (ref**2).sum(-1), ref.T.contiguous()
    dists, idx = [], []
    for s in range(0, query.shape[0], chunk):
        top = torch.topk(_sq_dists(query[s:s + chunk], ref_t, sq), k, dim=1, largest=False, sorted=True)
        dists.append(top.values)
        idx.append(top.indices)
    return torch.clamp_min(torch.cat(dists), 0.0), torch.cat(idx)
