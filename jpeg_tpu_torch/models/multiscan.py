"""Non-interleaved (multi-scan) baseline encoding: one SOS per component
(T.81 A.2.2). Some pipelines prefer this layout: components decode
independently, and a gray preview needs only the first scan. The port's
decoder and libjpeg both read it.

Counterpart of jpeg_tpu/models/multiscan.py: the transform runs on the
device (the exact integer transform of ops/mcu_conv), the three scans are
packed on the host by the native runtime, and the markers are written as the
reference writes them.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from jpeg_tpu_torch import tables as T
from jpeg_tpu_torch.config import EncodeConfig, Subsampling
from jpeg_tpu_torch.entropy import huffman, native
from jpeg_tpu_torch.io import bmp, jfif
from jpeg_tpu_torch.models import encoder as E
from jpeg_tpu_torch.ops import quant, tile


def encode_noninterleaved(
    image,
    quality: int = 75,
    restart_interval: int = 0,
    optimize_tables: bool = False,
    device="cuda",
) -> bytes:
    """Encode RGB to a 3-scan non-interleaved baseline JFIF stream, with the
    transform on `device` (on PyTorch's current stream) and the scans packed
    on the host.

    Always 4:4:4 (with (1,1) sampling everywhere, non-interleaved and
    interleaved MCU geometry coincide, so every baseline decoder agrees on
    the layout)."""
    if isinstance(image, str):
        image = bmp.read_bmp(image)
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {image.shape}")
    cfg = EncodeConfig(quality=quality, subsampling="444",
                       restart_interval=restart_interval,
                       optimize_tables=optimize_tables)
    h0, w0 = image.shape[:2]
    mode = Subsampling.YUV444

    img = tile.pad_to_multiple(
        torch.as_tensor(np.ascontiguousarray(image), device=device), 8, 8)
    qy_np, qc_np = quant.luma_table(quality), quant.chroma_table(quality)
    y, cb, cr = (
        a.cpu().numpy().astype(np.int64)
        for a in E._transform_color(img, qy_np, qc_np, mode)
    )

    r = cfg.restart_interval
    comps = [(1, 0, y), (2, 1, cb), (3, 1, cr)]
    scans = []
    all_blocks = []
    for cid, tid, blocks in comps:
        b = blocks.copy()
        b[:, 0] = E._dpcm_host(b[:, 0], r)
        tbl = np.full(len(b), tid, dtype=np.int64)
        all_blocks.append((b, tbl))

    if optimize_tables:
        freqs = None
        for b, tbl in all_blocks:
            f = native.count_frequencies(b, tbl)
            if freqs is None:
                freqs = {k: v.copy() for k, v in f.items()}
            else:
                for k in freqs:
                    freqs[k] = freqs[k] + f[k]
        htables = {k: huffman.optimal_table(v) for k, v in freqs.items()}
    else:
        htables = huffman.standard_tables()

    for (cid, tid, _), (b, tbl) in zip(comps, all_blocks):
        scan = native.encode_scan(b, tbl, htables, restart_interval=r,
                                  blocks_per_mcu=1)
        scans.append((cid, tid, scan))

    out = [b"\xff\xd8"]
    app0 = b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 1, 72, 72, 0, 0)
    out.append(struct.pack(">BBH", 0xFF, jfif.APP0, len(app0) + 2) + app0)
    for qid, q in [(0, qy_np), (1, qc_np)]:
        zz = np.asarray(q, np.int32).reshape(64)[T.ZIGZAG_ORDER]
        out.append(struct.pack(">BBH", 0xFF, jfif.DQT, 67) + bytes([qid])
                   + bytes(int(x) for x in zz))
    sof = struct.pack(">BHHB", 8, h0, w0, 3)
    for cid, qid in [(1, 0), (2, 1), (3, 1)]:
        sof += struct.pack(">BBB", cid, 0x11, qid)
    out.append(struct.pack(">BBH", 0xFF, jfif.SOF0, len(sof) + 2) + sof)
    for (is_ac, tid), t in sorted(htables.items()):
        if len(t.vals) == 0:
            continue
        p = bytes([(is_ac << 4) | tid]) + bytes(int(x) for x in t.bits) \
            + bytes(int(x) for x in t.vals)
        out.append(struct.pack(">BBH", 0xFF, jfif.DHT, len(p) + 2) + p)
    if r:
        out.append(struct.pack(">BBHH", 0xFF, jfif.DRI, 4, r))
    for cid, tid, scan in scans:
        sos = bytes([1]) + struct.pack(">BB", cid, (tid << 4) | tid) \
            + bytes([0, 63, 0])
        out.append(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
        out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)
