"""Progressive (SOF2) scan decoding: spectral selection + successive
approximation (ITU-T T.81 Annex G, decode side).

The reference has no decoder at all; progressive mode is implemented here for
foreign-stream coverage (most web JPEGs are progressive). Each scan refines a
per-component zig-zag coefficient grid on the host; once all scans are merged
the normal device finishing program (dequantize + IDCT + upsample + color)
runs unchanged — progressive vs sequential only changes the entropy layer.

Scan kinds (G.1.1.1):
  DC first   (Ss=0, Ah=0): baseline DC diffs, values << Al; may interleave
              components (MCU order).
  DC refine  (Ss=0, Ah>0): one correction bit per block.
  AC first   (Ss>0, Ah=0): (run, size) symbols within [Ss, Se] plus EOBn
              run-length codes (end-of-band runs across blocks).
  AC refine  (Ss>0, Ah>0): correction bits for already-nonzero coefficients
              and sign bits for newly nonzero ones (libjpeg's
              decode_mcu_AC_refine algorithm).

Restart markers reset DC predictors and the EOB run (F.2.1.3.1).
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy import decode_np
from jpeg_tpu_torch.entropy.decode_np import ScanDecodeError, _extend


class BitReader:
    """MSB-first bit reader over unstuffed entropy-coded bytes."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, segment: bytes):
        b = decode_np.unstuff(segment)
        self.nbits = len(b) * 8
        self.data = np.concatenate(
            [b, np.zeros(4096, dtype=np.uint8)]
        ).tolist()
        self.pos = 0

    def check(self):
        if self.pos > self.nbits:
            raise ScanDecodeError("bit cursor ran past segment end")

    def peek16(self) -> int:
        # Truncated/corrupt scans can free-run on zero guard bytes; fail as
        # soon as the cursor leaves the guard region instead of IndexError.
        if self.pos > self.nbits + 64:
            raise ScanDecodeError("bit cursor ran past segment end")
        i, sh = self.pos >> 3, self.pos & 7
        d = self.data
        return ((d[i] << 16 | d[i + 1] << 8 | d[i + 2]) >> (8 - sh)) & 0xFFFF

    def decode(self, lut) -> int:
        sym_lut, len_lut = lut
        w = self.peek16()
        sym = int(sym_lut[w])
        if sym < 0:
            raise ScanDecodeError(f"bad Huffman code at bit {self.pos}")
        self.pos += int(len_lut[w])
        return sym

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        w = self.peek16()
        self.pos += n
        return w >> (16 - n)

    def read_bit(self) -> int:
        if self.pos > self.nbits + 64:
            raise ScanDecodeError("bit cursor ran past segment end")
        i, sh = self.pos >> 3, self.pos & 7
        self.pos += 1
        return (self.data[i] >> (7 - sh)) & 1


def _dc_first_segment(br, blocks_iter, luts_by_comp, preds, al):
    for ci, coef in blocks_iter:
        diff_size = br.decode(luts_by_comp[ci])
        diff = _extend(br.receive(diff_size), diff_size)
        preds[ci] += diff
        coef[0] = preds[ci] << al
    br.check()


def _dc_refine_segment(br, blocks_iter, p1):
    for _ci, coef in blocks_iter:
        if br.read_bit():
            coef[0] |= p1
    br.check()


def _ac_first_segment(br, blocks, lut, ss, se, al, eobrun):
    for coef in blocks:
        if eobrun > 0:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            sym = br.decode(lut)
            r, s = sym >> 4, sym & 15
            if s == 0:
                if r != 15:
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += br.receive(r)
                    break
                k += 16  # ZRL
            else:
                k += r
                if k > se:
                    raise ScanDecodeError("AC run past end of band")
                coef[k] = _extend(br.receive(s), s) << al
                k += 1
    br.check()
    return eobrun


def _ac_refine_segment(br, blocks, lut, ss, se, al, eobrun):
    p1 = 1 << al
    m1 = -1 << al
    for coef in blocks:
        k = ss
        if eobrun == 0:
            while k <= se:
                sym = br.decode(lut)
                r, s = sym >> 4, sym & 15
                val = 0
                if s:
                    # s is 1 by spec; the new coefficient's sign bit.
                    val = p1 if br.read_bit() else m1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.receive(r)
                    break  # EOB run includes this block: handled below
                # Advance over r zero-history coefficients, emitting
                # correction bits for every nonzero-history one passed.
                while k <= se:
                    if coef[k] != 0:
                        if br.read_bit() and not (coef[k] & p1):
                            coef[k] += p1 if coef[k] >= 0 else m1
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if val:
                    if k > se:
                        raise ScanDecodeError("AC refine run past band end")
                    coef[k] = val
                k += 1
        if eobrun > 0:
            # Remaining band positions: correction bits for nonzero history.
            while k <= se:
                if coef[k] != 0 and br.read_bit() and not (coef[k] & p1):
                    coef[k] += p1 if coef[k] >= 0 else m1
                k += 1
            eobrun -= 1
    br.check()
    return eobrun


def decode_progressive(info, backend: str = "auto") -> list[np.ndarray]:
    """All scans -> per-component (gh*gw, 64) int32 zig-zag grids in plane
    raster order, padded to the interleaved MCU geometry (same contract the
    sequential multi-scan decoder feeds the finishing program).

    backend: "native" (C++ scan walker, threaded across restart segments),
    "numpy" (pure-Python BitReader), or "auto" (the native one). The
    two are bit-identical on every grid.
    """
    from jpeg_tpu_torch.io import jfif
    from jpeg_tpu_torch.models import layout

    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)
    by_id = {c.comp_id: (i, c) for i, c in enumerate(comps)}

    from jpeg_tpu_torch.entropy import native

    if backend == "auto":
        backend = "native"  # a failed build raises at the first scan

    grids = []
    dims = []  # (bh, bw) of each component's own block raster
    for c in comps:
        cw = layout.ceil_div(info.width * c.h, hmax)
        ch = layout.ceil_div(info.height * c.v, vmax)
        bw, bh = layout.ceil_div(cw, 8), layout.ceil_div(ch, 8)
        gh, gw = (mcu_rows * c.v, mcu_cols * c.h) if len(comps) > 1 else (bh, bw)
        grids.append(np.zeros((gh, gw, 64), dtype=np.int32))
        dims.append((bh, bw))

    for scan in info.scans:
        ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
        if ss == 0 and se != 0:
            raise jfif.JpegFormatError(
                "progressive scan mixes DC and AC bands"
            )
        if ss != 0 and len(scan.comp_ids) != 1:
            raise jfif.JpegFormatError("interleaved progressive AC scan")
        # Every scan kind except DC refinement (ss==0, ah>0 — raw bits only)
        # reads Huffman codes; the referenced tables must exist (a corrupt
        # SOS can name an undefined slot — surface a format error, not a
        # KeyError).
        if not (ss == 0 and ah != 0):
            for _cid, dc_id, ac_id in scan.comp_ids:
                key = (0, dc_id) if ss == 0 else (1, ac_id)
                if key not in scan.htables:
                    raise jfif.JpegFormatError(
                        f"scan references undefined Huffman table "
                        f"{'AC' if key[0] else 'DC'} {key[1]}"
                    )

        if backend == "native":
            _native_scan(scan, grids, dims, by_id, mcu_rows, mcu_cols)
            continue

        luts = {
            k: decode_np.make_decode_lut(t) for k, t in scan.htables.items()
        }
        if ss == 0:
            _decode_dc_scan(info, scan, luts, grids, dims, by_id,
                            mcu_rows, mcu_cols, ah, al)
        else:
            _decode_ac_scan(scan, luts, grids, dims, by_id, ss, se, ah, al)

    return [g.reshape(-1, 64) for g in grids]


def _native_scan(scan, grids, dims, by_id, mcu_rows, mcu_cols):
    """Dispatch one scan to the C++ walker (native.progressive_scan)."""
    from jpeg_tpu_torch.entropy import native

    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    interleaved = ss == 0 and len(scan.comp_ids) > 1
    comp_geom, scan_grids, tables = [], [], []
    for cid, dc_id, ac_id in scan.comp_ids:
        ci, c = by_id[cid]
        bh, bw = dims[ci]
        gw = grids[ci].shape[1]
        comp_geom.append((c.v, c.h, gw, bw))
        scan_grids.append(grids[ci])
        if ss == 0:
            tables.append(scan.htables[(0, dc_id)] if ah == 0 else None)
        else:
            tables.append(scan.htables[(1, ac_id)])
    if interleaved:
        n_units = mcu_rows * mcu_cols
    else:
        ci, _c = by_id[scan.comp_ids[0][0]]
        bh, bw = dims[ci]
        n_units = bh * bw
    kind = (0 if ah == 0 else 1) if ss == 0 else (2 if ah == 0 else 3)
    native.progressive_scan(
        scan.data, kind, ss, se, al, n_units,
        scan.restart_interval or 0, mcu_cols, comp_geom, scan_grids, tables,
    )


def _mcu_blocks_interleaved(scan, grids, dims, by_id, mcu_rows, mcu_cols,
                            first_mcu, n_mcu):
    """Yield (comp_index, coef_row) per block in interleaved MCU order."""
    members = []
    for cid, _dc, _ac in scan.comp_ids:
        ci, c = by_id[cid]
        members.append((ci, c))
    for m in range(first_mcu, first_mcu + n_mcu):
        i, j = divmod(m, mcu_cols)
        for ci, c in members:
            for a in range(c.v):
                for b in range(c.h):
                    yield ci, grids[ci][i * c.v + a, j * c.h + b]


def _decode_dc_scan(info, scan, luts, grids, dims, by_id, mcu_rows, mcu_cols,
                    ah, al):
    interleaved = len(scan.comp_ids) > 1
    if interleaved:
        n_units = mcu_rows * mcu_cols
    else:
        cid = scan.comp_ids[0][0]
        ci, _c = by_id[cid]
        bh, bw = dims[ci]
        n_units = bh * bw

    segments = decode_np.split_restart_segments(scan.data)
    r = scan.restart_interval if scan.restart_interval else n_units
    if len(segments) != (n_units + r - 1) // r:
        raise ScanDecodeError(
            f"expected {(n_units + r - 1) // r} restart segments, "
            f"found {len(segments)}"
        )
    luts_by_comp = {}
    for cid, dc_id, _ac in scan.comp_ids:
        ci, _ = by_id[cid]
        if ah == 0:
            luts_by_comp[ci] = luts[(0, dc_id)]

    preds = [0] * len(grids)
    for s, seg in enumerate(segments):
        br = BitReader(seg)
        first = s * r
        n = min(r, n_units - first)
        for p in range(len(preds)):
            preds[p] = 0
        if interleaved:
            it = _mcu_blocks_interleaved(
                scan, grids, dims, by_id, mcu_rows, mcu_cols, first, n
            )
        else:
            cid = scan.comp_ids[0][0]
            ci, _c = by_id[cid]
            bh, bw = dims[ci]
            it = (
                (ci, grids[ci][u // bw, u % bw])
                for u in range(first, first + n)
            )
        if ah == 0:
            _dc_first_segment(br, it, luts_by_comp, preds, al)
        else:
            _dc_refine_segment(br, it, 1 << al)


def _decode_ac_scan(scan, luts, grids, dims, by_id, ss, se, ah, al):
    cid, _dc, ac_id = scan.comp_ids[0]
    ci, _c = by_id[cid]
    bh, bw = dims[ci]
    n_units = bh * bw
    lut = luts[(1, ac_id)]

    segments = decode_np.split_restart_segments(scan.data)
    r = scan.restart_interval if scan.restart_interval else n_units
    if len(segments) != (n_units + r - 1) // r:
        raise ScanDecodeError(
            f"expected {(n_units + r - 1) // r} restart segments, "
            f"found {len(segments)}"
        )
    for s, seg in enumerate(segments):
        br = BitReader(seg)
        first = s * r
        n = min(r, n_units - first)
        blocks = (grids[ci][u // bw, u % bw] for u in range(first, first + n))
        if ah == 0:
            _ac_first_segment(br, blocks, lut, ss, se, al, 0)
        else:
            _ac_refine_segment(br, blocks, lut, ss, se, al, 0)
