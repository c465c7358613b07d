"""Edge-image visualization: keylines painted over the frame
(rebvio_tpu/utils/visualize.py; the reference's edge-image publisher,
ros_rebvio.cpp:32-51, keylines painted red over the camera image), without
ROS: an RGB numpy array, and a PNG writer."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def render_edge_image(frame, edge_map, gain: float = 1.0, max_val: float = 255.0) -> np.ndarray:
    """[H,W,3] uint8: the grayscale frame with valid keylines in red, matched
    keylines brighter.  ``frame`` and ``edge_map``'s planes may be tensors on
    any device or numpy arrays."""
    img = np.clip(_np(frame).astype(np.float32) * gain, 0, max_val)
    g = (img / max_val * 255).astype(np.uint8)
    out = np.stack([g, g, g], axis=-1)
    pos = _np(edge_map.pos)
    valid = _np(edge_map.valid)
    matched = _np(edge_map.match_id) >= 0
    H, W = g.shape
    xs = np.clip(np.floor(pos[:, 0] + 0.5).astype(int), 0, W - 1)
    ys = np.clip(np.floor(pos[:, 1] + 0.5).astype(int), 0, H - 1)
    sel = valid & ~matched
    out[ys[sel], xs[sel]] = [200, 40, 40]
    sel = valid & matched
    out[ys[sel], xs[sel]] = [255, 64, 64]
    return out


def write_png_rgb(path: str, img: np.ndarray) -> None:
    """Minimal RGB PNG writer (no external dependency)."""
    H, W, C = img.shape
    if C != 3:
        raise ValueError(f"write_png_rgb takes [H, W, 3], got {img.shape}")
    raw = b"".join(b"\x00" + img[r].astype(np.uint8).tobytes() for r in range(H))

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
