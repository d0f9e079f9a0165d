"""Camera and dataset conversion (counterpart of gaustar_tpu/tools/cmr_convert.py;
gaustar_tools/cmr_convert.py, data_process/ahq2gaustar.py).

COLMAP text export (cameras.txt / images.txt with cx, cy forced to the image
centre, cmr_convert.py:16-61; the dataset images are shifted to match), the
principal-point recentring of an image, and the ActorsHQ converter's camera
packing (ahq2gaustar.py:13-47). The JAX package's two OpenCV calls are
written in numpy: cv2.warpAffine of a translation (recenter_image) and
cv2.Rodrigues (rodrigues).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from gaustar_tpu_torch.tools.geometry import project, query_at_image

def rotmat2qvec(R):
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion (cmr_convert.py:31-42)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def rodrigues(rvec) -> np.ndarray:
    """Axis-angle vector -> 3x3 rotation (cv2.Rodrigues, float64):
    cos t I + (1 - cos t) k k^T + sin t [k]x with t = |rvec|, k = rvec / t;
    the identity below float64's epsilon."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    k = r * (1.0 / theta)
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def write_cameras_text(intr, shape, path):
    """COLMAP cameras.txt, PINHOLE with the principal point at the centre
    (cmr_convert.py:16-28)."""
    n = intr.shape[0]
    header = (
        "# Camera list with one line of data per camera:\n"
        "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[fx,fy,cx,cy]\n"
        f"# Number of cameras: {n}\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for i in range(n):
            row = [i, "PINHOLE", shape[i, 1], shape[i, 0],
                   intr[i][0, 0], intr[i][1, 1], shape[i, 1] * 0.5, shape[i, 0] * 0.5]
            f.write(" ".join(str(x) for x in row) + "\n")


def write_images_text(extrinsics, path):
    """COLMAP images.txt from w2c extrinsics (cmr_convert.py:45-61)."""
    n = extrinsics.shape[0]
    header = (
        "# Image list with two lines of data per image:\n"
        "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
        "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
        f"# Number of images: {n}, mean observations per image: 0\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for i in range(n):
            e = extrinsics[i]
            q = rotmat2qvec(e[0:3, 0:3])
            t = e[0:3, 3]
            f.write(" ".join(map(str, [i, *q, *t, i, f"img_{i:04d}.jpg"])) + "\n")


def export_colmap(path, intr, extr, shape):
    """Write sparse/0/{cameras,images}.txt (cmr_convert.py:64-68)."""
    colmap_dir = os.path.join(path, "sparse", "0")
    os.makedirs(colmap_dir, exist_ok=True)
    write_cameras_text(intr, shape, os.path.join(colmap_dir, "cameras.txt"))
    write_images_text(extr, os.path.join(colmap_dir, "images.txt"))


def recenter_image(img, intr_mat, border_value=None):
    """Shift an image so that its principal point lands at the centre
    (cmr_convert.py:102-112, ahq2gaustar.py:50-81), as cv2.warpAffine of the
    translation with INTER_LINEAR and a constant border (border_value, a
    number or one per channel; default 0) computes it: output pixel (x, y)
    samples the source at (x + dx, y + dy) in float32, taps outside the
    image take the border value, each row is a lerp along x and then the
    two rows one along y; uint8 rounds half to even."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    cval = np.zeros(img.shape[2:], np.float32)
    if border_value is not None:  # a number is its first channel's value, as in OpenCV's Scalar
        bv = np.ravel(np.asarray(border_value, np.float32))
        cval.reshape(-1)[: min(cval.size, bv.size)] = bv[: cval.size]
    pad = np.empty((h + 4, w + 4, *img.shape[2:]), np.float32)
    pad[...] = cval
    pad[2:-2, 2:-2] = img

    def taps(n, shift):
        s = np.arange(n, dtype=np.float32) + np.float32(shift)
        i = np.floor(s)
        return np.clip(i.astype(np.int64), -2, n) + 2, (s - i).astype(np.float32)

    xs, fx = taps(w, intr_mat[0, 2] - 0.5 * w)
    ys, fy = taps(h, intr_mat[1, 2] - 0.5 * h)
    ch = (None,) * (img.ndim - 2)
    fx = fx[(None, slice(None)) + ch]
    fy = fy[(slice(None), None) + ch]
    rows = []
    for dy in (0, 1):
        p0 = pad[ys[:, None] + dy, xs[None, :]]
        p1 = pad[ys[:, None] + dy, xs[None, :] + 1]
        rows.append(p0 + (p1 - p0) * fx)
    out = rows[0] + (rows[1] - rows[0]) * fy
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def read_actorshq_calibration(csv_path: str):
    """Parse an ActorsHQ calibration.csv into rgb_cameras.npz arrays
    (ahq2gaustar.py:13-47): per camera the rotation (Rodrigues axis-angle),
    translation, focal and principal point in normalised units, image size."""
    intr_list, extr_list, shape_list = [], [], []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            w, h = int(row["w"]), int(row["h"])
            fx = float(row["fx"]) * w
            fy = float(row["fy"]) * h
            cx = float(row["px"]) * w
            cy = float(row["py"]) * h
            R = rodrigues([float(row["rx"]), float(row["ry"]), float(row["rz"])])
            t = np.array([float(row["tx"]), float(row["ty"]), float(row["tz"])])
            # ActorsHQ stores camera-to-world; GauSTAR wants world-to-camera.
            w2c = np.eye(4)
            w2c[:3, :3] = R.T
            w2c[:3, 3] = -R.T @ t
            intr_list.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))
            extr_list.append(w2c)
            shape_list.append([h, w])
    return {
        "intrinsics": np.asarray(intr_list),
        "extrinsics": np.asarray(extr_list),
        "shape": np.asarray(shape_list, np.int64),
    }


def save_rgb_cameras(path: str, cmr: dict):
    np.savez(path, **cmr)


def color_mesh_from_views(verts, faces, images, depths, cmr, depth_agreement=0.01, min_views=1):
    """Vertex colours by multi-view voting with depth visibility
    (ahq2gaustar.py:124-160): each vertex averages the colour of every
    camera that sees it (its projected depth agrees with the GT depth map).
    images [C, H, W, 3] in [0, 1]; depths [C, H, W]; cmr: rgb_cameras arrays.
    Returns vertex colours [V, 3]."""
    verts = np.asarray(verts, np.float64)
    acc = np.zeros((len(verts), 3))
    cnt = np.zeros(len(verts))
    for ci in range(len(images)):
        shape = depths[ci].shape
        pix, local = project(verts, cmr["intrinsics"][ci], cmr["extrinsics"][ci], shape, return_local_points=True)
        d, ok = query_at_image(depths[ci], pix, return_valid=True)
        vis = ok & (np.abs(local[..., 2] - d) < depth_agreement)
        col = query_at_image(images[ci], pix)
        acc[vis] += col[vis]
        cnt[vis] += 1
    colors = np.full((len(verts), 3), 0.5)
    seen = cnt >= min_views
    colors[seen] = acc[seen] / cnt[seen, None]
    return colors
