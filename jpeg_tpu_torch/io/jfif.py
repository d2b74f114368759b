"""JFIF container: marker segment writer and parser.

The serialization layer the reference never wrote (SURVEY.md: "no JFIF/marker
serialization, no fwrite anywhere in the tree"; its `src/headers/tables.h` only
*staged* DHT data). Written from ITU-T T.81 Annex B + the JFIF 1.02 spec.

Baseline sequential DCT (SOF0), 8-bit precision, 1 or 3 components.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from jpeg_tpu_torch import tables as T
from jpeg_tpu_torch.entropy.huffman import HuffTable, build_table

SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DNL = 0xDC
DRI = 0xDD
APP0 = 0xE0
APP14 = 0xEE
COM = 0xFE
SOF0 = 0xC0
SOF1 = 0xC1
SOF2 = 0xC2
DHT = 0xC4


def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _byte_values(values) -> bytes:
    """An integer array's values, each in range(0, 256), as one byte each
    (bytes() of a list of Python ints: a C loop, where a generator of numpy
    scalars is a Python one)."""
    return bytes(np.asarray(values).reshape(-1).tolist())


@dataclasses.dataclass
class ComponentSpec:
    comp_id: int
    h: int  # horizontal sampling factor
    v: int  # vertical sampling factor
    qtab_id: int
    dc_id: int = 0
    ac_id: int = 0


@dataclasses.dataclass
class ScanInfo:
    """One SOS header + its entropy-coded data.

    Tables/DRI may be redefined between scans, so each scan snapshots them.
    """

    comp_ids: list  # [(comp_id, dc_id, ac_id)] in scan order
    data: bytes  # entropy-coded bytes incl. RSTn markers
    restart_interval: int
    htables: dict  # (is_ac, id) -> HuffTable at the time of this scan
    # Spectral selection / successive approximation (progressive scans;
    # 0, 63, 0, 0 for sequential baseline).
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0


@dataclasses.dataclass
class FrameInfo:
    """Everything a decoder needs, parsed from the marker stream.

    scan_data/htables/restart_interval mirror the FIRST scan (the common
    single-scan interleaved case); `scans` lists all of them for
    non-interleaved multi-scan baseline streams.
    """

    width: int
    height: int
    components: list  # [ComponentSpec]
    qtables: dict  # id -> (64,) int array in zig-zag order
    htables: dict  # (is_ac, id) -> HuffTable
    restart_interval: int
    scan_data: bytes  # entropy-coded bytes incl. RSTn markers, excl. EOI
    progressive: bool = False
    scans: list = dataclasses.field(default_factory=list)
    # Adobe APP14 color-transform byte (0 = no transform / RGB, 1 = YCbCr,
    # 2 = YCCK); None when the marker is absent.
    adobe_transform: int | None = None


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def write_jpeg(
    width: int,
    height: int,
    components: list,
    qtables: dict,
    htables: dict,
    scan_data: bytes,
    restart_interval: int = 0,
    comment: str | None = None,
    adobe_transform: int | None = None,
) -> bytes:
    """Assemble a baseline JFIF stream. scan_data may be any bytes-like
    object (a numpy uint8 array too); it is copied once, into the result.

    qtables: id -> (8, 8) raster-order table; stored zig-zagged per spec.
    htables: (is_ac, id) -> HuffTable.
    adobe_transform: emit an Adobe APP14 marker with this transform byte
    (0 = untransformed, 1 = YCbCr, 2 = YCCK — needed for 4-component
    CMYK/YCCK streams, which decoders key off the marker).
    """
    return b"".join((
        write_header(width, height, components, qtables, htables,
                     restart_interval, comment, adobe_transform),
        scan_data,
        struct.pack(">BB", 0xFF, EOI),
    ))


def write_header(
    width: int,
    height: int,
    components: list,
    qtables: dict,
    htables: dict,
    restart_interval: int = 0,
    comment: str | None = None,
    adobe_transform: int | None = None,
) -> bytes:
    """Everything up to and including SOS — the streaming half of write_jpeg:
    callers append entropy-coded scan chunks and a final EOI themselves
    (parallel/mosaic.py encode_mosaic_stream)."""
    out = [struct.pack(">BB", 0xFF, SOI)]
    # APP0 / JFIF 1.01, no thumbnail, 72 dpi.
    out.append(_seg(APP0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 1, 72, 72, 0, 0)))
    if adobe_transform is not None:
        out.append(_seg(APP14, b"Adobe" + struct.pack(
            ">HHHB", 0x64, 0, 0, adobe_transform)))
    if comment:
        out.append(_seg(COM, comment.encode("utf-8")))

    for qid in sorted(qtables):
        q = np.asarray(qtables[qid], dtype=np.int32).reshape(64)
        zz = q[T.ZIGZAG_ORDER]
        out.append(_seg(DQT, bytes([qid]) + _byte_values(zz)))

    ncomp = len(components)
    sof = struct.pack(">BHHB", 8, height, width, ncomp)
    for c in components:
        sof += struct.pack(">BBB", c.comp_id, (c.h << 4) | c.v, c.qtab_id)
    out.append(_seg(SOF0, sof))

    for (is_ac, hid) in sorted(htables):
        t: HuffTable = htables[(is_ac, hid)]
        payload = bytes([(is_ac << 4) | hid])
        payload += _byte_values(t.bits)
        payload += _byte_values(t.vals)
        out.append(_seg(DHT, payload))

    if restart_interval:
        out.append(_seg(DRI, struct.pack(">H", restart_interval)))

    sos = bytes([ncomp])
    for c in components:
        sos += struct.pack(">BB", c.comp_id, (c.dc_id << 4) | c.ac_id)
    sos += bytes([0, 63, 0])  # Ss, Se, Ah/Al for sequential DCT
    out.append(_seg(SOS, sos))
    return b"".join(out)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class JpegFormatError(ValueError):
    pass


def parse_jpeg(data: bytes) -> FrameInfo:
    """Walk the full marker stream (all scans). Malformed input raises
    JpegFormatError."""
    try:
        return _parse_jpeg(data)
    except (struct.error, IndexError, KeyError) as e:
        raise JpegFormatError(f"malformed JPEG stream: {e}") from e


def _parse_jpeg(data: bytes) -> FrameInfo:
    if len(data) < 4 or data[0] != 0xFF or data[1] != SOI:
        raise JpegFormatError("missing SOI")
    pos = 2
    qtables: dict = {}
    htables: dict = {}
    components: list = []
    scans: list = []
    width = height = 0
    restart_interval = 0
    progressive = False
    adobe_transform = None

    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            raise JpegFormatError(f"expected marker at offset {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == EOI:
            if scans:
                return _finish_frame(
                    width, height, components, qtables, scans, progressive,
                    adobe_transform,
                )
            raise JpegFormatError("EOI before SOS (no image data)")
        if marker in (0x01, *range(0xD0, 0xD8)):  # TEM / RSTn: standalone
            continue
        if pos + 2 > len(data):
            raise JpegFormatError("truncated segment header")
        seglen = struct.unpack_from(">H", data, pos)[0]
        payload = data[pos + 2 : pos + seglen]
        pos += seglen

        if marker == DQT:
            p = 0
            while p < len(payload):
                pq, tq = payload[p] >> 4, payload[p] & 15
                p += 1
                if pq == 0:
                    vals = np.frombuffer(payload, np.uint8, 64, p).astype(np.int32)
                    p += 64
                else:
                    vals = np.frombuffer(payload, ">u2", 64, p).astype(np.int32)
                    p += 128
                raster = np.zeros(64, np.int32)
                raster[T.ZIGZAG_ORDER] = vals
                qtables[tq] = raster.reshape(8, 8)
        elif marker == DHT:
            p = 0
            while p < len(payload):
                tc, th = payload[p] >> 4, payload[p] & 15
                bits = np.frombuffer(payload, np.uint8, 16, p + 1).astype(np.int32)
                n = int(bits.sum())
                vals = np.frombuffer(payload, np.uint8, n, p + 17).astype(np.int32)
                htables[(tc, th)] = build_table(bits, vals)
                p += 17 + n
        elif marker in (SOF0, SOF1, SOF2):
            if marker == SOF2:
                progressive = True
            prec, height, width, nc = struct.unpack_from(">BHHB", payload, 0)
            if prec != 8:
                raise JpegFormatError(f"unsupported precision {prec}")
            if width == 0 or height == 0 or nc == 0:
                raise JpegFormatError(
                    f"bad frame geometry {width}x{height}x{nc}"
                )
            components = []
            for i in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", payload, 6 + 3 * i)
                components.append(ComponentSpec(cid, hv >> 4, hv & 15, tq))
        elif marker == DRI:
            restart_interval = struct.unpack_from(">H", payload, 0)[0]
        elif marker == APP14 and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe_transform = payload[11]
        elif marker == SOS:
            if not components:
                raise JpegFormatError("SOS before SOF")
            ns = payload[0]
            by_id = {c.comp_id: c for c in components}
            comp_ids = []
            for i in range(ns):
                cid, td_ta = payload[1 + 2 * i], payload[2 + 2 * i]
                by_id[cid].dc_id = td_ta >> 4
                by_id[cid].ac_id = td_ta & 15
                comp_ids.append((cid, td_ta >> 4, td_ta & 15))
            ss, se, ahal = (
                payload[1 + 2 * ns], payload[2 + 2 * ns], payload[3 + 2 * ns]
            )
            scan_start = pos
            scan_end = _find_scan_end(data, scan_start)
            scans.append(
                ScanInfo(
                    comp_ids=comp_ids,
                    data=data[scan_start:scan_end],
                    restart_interval=restart_interval,
                    htables=dict(htables),
                    ss=ss, se=se, ah=ahal >> 4, al=ahal & 15,
                )
            )
            pos = scan_end
            # Continue: more scans (non-interleaved baseline) may follow.
        # all other markers (APPn, COM, ...) are skipped
    if scans:
        return _finish_frame(width, height, components, qtables, scans,
                             progressive, adobe_transform)
    raise JpegFormatError("no SOS found")


def _finish_frame(width, height, components, qtables, scans, progressive,
                  adobe_transform=None):
    first: ScanInfo = scans[0]
    return FrameInfo(
        width=width,
        height=height,
        components=components,
        qtables=qtables,
        htables=first.htables,
        restart_interval=first.restart_interval,
        scan_data=first.data,
        progressive=progressive,
        scans=scans,
        adobe_transform=adobe_transform,
    )


def _find_scan_end(data: bytes, start: int) -> int:
    """Find the end of entropy-coded data: first FF xx where xx is a real
    marker (not 00 stuffing, not RSTn)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    ff = np.nonzero(buf[start:-1] == 0xFF)[0]
    nxt = buf[start + ff + 1]
    real = (nxt != 0x00) & ~((nxt >= 0xD0) & (nxt <= 0xD7))
    hits = ff[real]
    if len(hits) == 0:
        return len(data)
    return start + int(hits[0])
