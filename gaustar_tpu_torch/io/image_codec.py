"""Image files without PIL (the card's machine has neither PIL nor OpenCV).

PNG: 8-bit gray, gray + alpha, RGB and RGBA, plain or Adam7-interlaced, read
with every one of the five row filters (None, Sub, Up, Average, Paeth) and
written non-interlaced with filter None, through zlib and numpy on the host.
Sub and Up rows are undone as array operations; Average and Paeth rows
depend on their left neighbour through a nonlinear step and run a Python
loop over the row's bytes, so a large image written with them reads slowly
(this module's writer never uses them).

JPEG: nvJPEG, the CUDA toolkit's codec (csrc/jpeg_codec.cu, built at first
use by ops/_build.py and linked with -lnvjpeg). A decoded frame lands on the
card as uint8 [H, W, 3] RGB; encoding takes such a tensor. There is no CPU
codec: `read_jpeg` / `write_jpeg` on the CPU raise. nvJPEG's IDCT differs
from libjpeg's (PIL) by a few levels per pixel.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS_OF_COLOR_TYPE = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE_OF_CHANNELS = {c: t for t, c in _CHANNELS_OF_COLOR_TYPE.items()}
# Adam7's seven passes: (x0, y0, dx, dy) of the pixels each holds (PNG spec, 8.2).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _paeth_row(line: list, prev: list, bpp: int) -> list:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 255
    return line


def _average_row(line: list, prev: list, bpp: int) -> list:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 255
    return line


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (PNG spec, section 9) -> [height, width * bpp]."""
    stride = width * bpp
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype, line = int(rows[r, 0]), rows[r, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.int64) & 255).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:
            cur = np.asarray(_average_row(line.tolist(), prev.tolist(), bpp), np.uint8)
        elif ftype == 4:
            cur = np.asarray(_paeth_row(line.tolist(), prev.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {ftype}")
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W] (gray) or [H, W, C] (C = 2, 3, 4), as np.asarray of PIL's
    image gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS_OF_COLOR_TYPE or interlace not in (0, 1):
        raise ValueError(f"{path}: only 8-bit gray/gray-alpha/RGB/RGBA PNGs are read "
                         f"(bit depth {depth}, colour type {color_type}, interlace {interlace})")
    bpp = _CHANNELS_OF_COLOR_TYPE[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        img = _unfilter(raw, height, width, bpp).reshape(height, width, bpp)
    else:
        # Each pass is a small image of its own, filtered on its own; a pass
        # with no pixels stores nothing.
        img = np.empty((height, width, bpp), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if w <= 0 or h <= 0:
                continue
            size = h * (w * bpp + 1)
            img[y0::dy, x0::dx] = _unfilter(raw[pos:pos + size], h, w, bpp).reshape(h, w, bpp)
            pos += size
    return img[..., 0] if bpp == 1 else img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def write_png(path: str, img) -> None:
    """Write uint8 [H, W] or [H, W, C] (C = 1-4) as an 8-bit PNG, every row
    with filter None."""
    a = np.asarray(img.cpu() if torch.is_tensor(img) else img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    height, width, channels = a.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8), a.reshape(height, width * channels)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE_OF_CHANNELS[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG (nvJPEG)
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_JPEG_ARGS = {
    "jpeg_info": [_P, _L, _P, _P, _P],  # data, length, *width, *height, *components
    "jpeg_decode": [_P, _L, _P, _I, _P],  # data, length, out, width, stream
    "jpeg_encode": [_P, _I, _I, _I, _P, _P, _P],  # rgb, width, height, quality, out, *length, stream
}


def _codec():
    from gaustar_tpu_torch.ops import _build

    return _build.load("jpeg_codec", _JPEG_ARGS)


def _no_cpu(device: torch.device, what: str):
    if device.type != "cuda":
        raise RuntimeError(f"{what} needs nvJPEG on a CUDA device (device {device}); "
                           "there is no CPU JPEG codec in this package")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed with nvJPEG/CUDA code {err}")


def decode_jpeg(data: bytes, device="cuda") -> torch.Tensor:
    """A JPEG bitstream -> uint8 [H, W, 3] RGB on the CUDA `device`."""
    device = torch.device(device)
    _no_cpu(device, "JPEG decoding")
    lib = _codec()
    buf = ctypes.create_string_buffer(data, len(data))
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _raise_on(lib.jpeg_info(ctypes.addressof(buf), len(data), ctypes.addressof(w), ctypes.addressof(h),
                            ctypes.addressof(c)), "jpeg_info")
    out = torch.empty((h.value, w.value, 3), dtype=torch.uint8, device=device)
    _raise_on(lib.jpeg_decode(ctypes.addressof(buf), len(data), out.data_ptr(), w.value,
                              torch.cuda.current_stream(device).cuda_stream), "jpeg_decode")
    return out


def read_jpeg(path: str, device="cuda") -> torch.Tensor:
    """Decode the JPEG file at `path` -> uint8 [H, W, 3] RGB on the CUDA
    `device`. Raises on the CPU."""
    _no_cpu(torch.device(device), f"reading {path}")
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), device)


def encode_jpeg(img: torch.Tensor, quality: int = 95) -> bytes:
    """uint8 [H, W, 3] RGB on a CUDA device -> a baseline JPEG bitstream at
    `quality`, 4:4:4 chroma."""
    _no_cpu(img.device, "JPEG encoding")
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 [H, W, 3], not {img.dtype} {tuple(img.shape)}")
    img = img.contiguous()
    lib = _codec()
    h, w = img.shape[:2]
    stream = torch.cuda.current_stream(img.device).cuda_stream
    cap = ctypes.c_longlong(h * w * 3 + (1 << 16))
    out = ctypes.create_string_buffer(cap.value)
    err = lib.jpeg_encode(img.data_ptr(), w, h, int(quality), ctypes.addressof(out), ctypes.addressof(cap), stream)
    if err == 1:  # the bitstream outgrew the buffer: retry at the size it needs
        out = ctypes.create_string_buffer(cap.value)
        err = lib.jpeg_encode(img.data_ptr(), w, h, int(quality), ctypes.addressof(out), ctypes.addressof(cap),
                              stream)
    _raise_on(err, "jpeg_encode")
    return out.raw[: cap.value]


def write_jpeg(path: str, img: torch.Tensor, quality: int = 95) -> None:
    """Encode uint8 [H, W, 3] RGB on a CUDA device to the file `path`."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
