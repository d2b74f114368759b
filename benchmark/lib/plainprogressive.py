"""A plain progressive JPEG writer in PyTorch: the stream that libjpeg's
`cjpeg -progressive` writes, made from the benchmark's own coefficients.

It imports nothing of the codec under test. The scan script is jcparam.c's
jpeg_simple_progression for three components (SCRIPT); the point transforms,
the end-of-band runs and the correction bits of the refinement scans follow
ITU-T T.81 Annex G as libjpeg's jcphuff.c codes them, and each scan's Huffman
tables are built from that scan's own symbol counts by Annex K.2
(plainjpeg.optimal_table), as jcmaster.c forces in progressive mode.

Every scan is made with whole-tensor operations over all blocks of all
images of one shape, as plainjpeg's baseline scans are: a block's fields get
keys that put them in stream order, and plainjpeg.place lays them out. Only
the end-of-band runs take a loop, since a run is cut at EOB_RUN_MAX blocks
or where a refinement scan's buffered correction bits pass BE_LIMIT: one
pass per run of the longest stretch, all stretches at once.

Successive approximation with every refinement scan rebuilds each
coefficient exactly, so a decode of these streams is held to the same
coefficients, and the same bounds, as one of the baseline stream.
"""

from __future__ import annotations

import torch

from lib import plainjpeg as P

# (components, Ss, Se, Ah, Al): jcparam.c jpeg_simple_progression, YCbCr.
# Component 0 is Y, 1 Cb, 2 Cr.
SCRIPT = (
    ((0, 1, 2), 0, 0, 0, 1),  # DC first
    ((0,), 1, 5, 0, 2),
    ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1),  # Y AC refinement
    ((0, 1, 2), 0, 0, 1, 0),  # DC refinement
    ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0),
)
# jcphuff.c: an end-of-band run is flushed at EOBRUN 0x7FFF, and in a
# refinement scan once its buffered correction bits pass MAX_CORR_BITS - 64
# + 1 (so that the next block's 63 cannot overflow the buffer).
EOB_RUN_MAX = 0x7FFF
MAX_CORR_BITS = 1000
BE_LIMIT = MAX_CORR_BITS - 64 + 1

# A field's key in its scan: ((block * 65 + position) * 4 + phase) * 1024 +
# index. Position 64 is after the block's last coefficient; index orders the
# correction bits (at most BE_LIMIT + 63 of them after one EOB run).
_POS, _PHASE, _INDEX = 65, 4, 1024


def _key(block, pos, phase, index):
    return ((block * _POS + pos) * _PHASE + phase) * _INDEX + index


def component_blocks(coefs: torch.Tensor, height: int, width: int,
                     subsampling: str) -> list:
    """(K, n_mcu, h * v + 2, 64) coefficients -> per component (Y, Cb, Cr)
    (K, blocks, 64) in the component's own block raster, row by row: the
    blocks that a non-interleaved scan codes (T.81 A.2.2), without those that
    only pad the MCUs."""
    k, n_mcu, nbm = coefs.shape[:3]
    h, v = P.SAMPLING[subsampling]
    mr, mc = P._mcus(height, width, h, v)
    y = coefs[:, :, :h * v].reshape(k, mr, mc, v, h, 64).permute(
        0, 1, 3, 2, 4, 5).reshape(k, mr * v, mc * h, 64)
    y = y[:, :-(-height // 8), :-(-width // 8)]
    return [y.reshape(k, -1, 64), coefs[:, :, -2], coefs[:, :, -1]]


def _dc_first(coefs, al):
    """DC first, all components interleaved in MCU order (rows: the K * n_mcu
    * (h * v + 2) blocks): the DC >> Al (an arithmetic shift) less the
    component's previous one, coded with table slot 0 (Y) or 1 (Cb and
    Cr)."""
    k, n_mcu, nbm = coefs.shape[:3]
    hv = nbm - 2
    dev = coefs.device
    dc = coefs[..., 0] >> al
    none = torch.zeros(1, dtype=torch.bool, device=dev)
    dy = P._dc_differences(dc[:, :, :hv].reshape(k, -1), none)
    dcc = P._dc_differences(dc[:, :, hv:], none)
    diff = torch.cat([dy.reshape(k, n_mcu, hv), dcc], dim=2).reshape(-1)
    size = P._bit_length(diff)
    row = torch.arange(diff.numel(), device=dev)
    slot = (row % nbm >= hv).to(torch.int64)
    return (row, _key(row % (n_mcu * nbm), 0, 0, 0), slot, size,
            P.amplitude(diff, size), size)


def _dc_refine(coefs, al):
    """DC refinement: bit Al of each DC value, in MCU order, no code."""
    bits = ((coefs[..., 0] >> al) & 1).reshape(-1)
    row = torch.arange(bits.numel(), device=coefs.device)
    return (row, _key(row % coefs[0, ..., 0].numel(), 0, 0, 0),
            torch.full_like(bits, -1), torch.zeros_like(bits), bits,
            torch.ones_like(bits))


def _eob_chunks(inc, group, w):
    """End-of-band runs. `inc` (R,) rows (blocks of the scan, all images)
    whose band ends in zeros or in coefficients seen before, each adding one
    to the run and its `w` correction bits to the run's buffer; `group` (R,)
    numbers the stretches between the points where the pending run must be
    emitted (a block that codes a symbol; the start of an image's scan).
    A run is also cut at EOB_RUN_MAX blocks and once its bits pass BE_LIMIT.

    Returns (rows: the incrementing rows; per such row its run, the rank of
    its first bit in the run's buffer; per run its length and the row of its
    last block, where it is emitted)."""
    rows = torch.nonzero(inc, as_tuple=True)[0]
    g, wi = group[rows], w[rows]
    n = rows.numel()
    idx = torch.arange(n, device=inc.device)
    new = torch.ones_like(rows, dtype=torch.bool)
    new[1:] = g[1:] != g[:-1]
    starts, ends = idx[new], _last_of(new)
    s_incl = torch.cumsum(wi, 0)
    s_excl = s_incl - wi
    cut = torch.zeros_like(rows, dtype=torch.bool)
    while starts.numel():
        cut[starts] = True
        e = torch.minimum(starts + EOB_RUN_MAX - 1, ends)
        e = torch.minimum(e, torch.searchsorted(
            s_incl, s_excl[starts] + BE_LIMIT + 1))
        more = e < ends
        starts, ends = e[more] + 1, ends[more]
    run = torch.cumsum(cut.to(torch.int64), 0) - 1
    first, last = idx[cut], _last_of(cut)
    return rows, run, s_excl - s_excl[first][run], last - first + 1, rows[last]


def _last_of(starts):
    """Index of the last element of each stretch that `starts` (bool) opens."""
    last = torch.ones_like(starts)
    last[:-1] = starts[1:]
    return torch.nonzero(last, as_tuple=True)[0]


def _eob_fields(length, row, nb):
    """The EOBn symbol of each run ((log2 length) << 4, then the length's
    low bits) at position 64 of the row of its last block."""
    nbits = P._bit_length(length) - 1
    return (row, _key(row % nb, 64, 0, 0), torch.zeros_like(row), nbits << 4,
            length & ((1 << nbits) - 1), nbits)


def _ac_first(x, ss, se, al):
    """AC first, one component: per block (R = K * blocks rows of `x`) the
    band [Ss, Se] of |coefficient| >> Al with the sign kept; per nonzero its
    ZRLs and its symbol; a block ending in zeros adds to the EOB run."""
    r, nb = x.shape[0] * x.shape[1], x.shape[1]
    dev = x.device
    band = x.reshape(r, 64)[:, ss:se + 1]
    mag = band.abs() >> al
    rows, cols = torch.nonzero(mag, as_tuple=True)
    a = mag[rows, cols]
    neg = band[rows, cols] < 0
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    prev = torch.where(first, torch.full_like(cols, -1),
                       torch.cat([cols[:1], cols[:-1]]))
    run = cols - prev - 1
    size = P._bit_length(a)
    extra = P.amplitude(torch.where(neg, -a, a), size)
    zidx = torch.repeat_interleave(torch.arange(rows.numel(), device=dev),
                                   run >> 4)
    zr = rows[zidx]
    zero_z = torch.zeros_like(zr)
    last = torch.full((r,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, rows, cols, reduce="amax")
    coded = torch.zeros(r, dtype=torch.bool, device=dev)
    coded[rows] = True
    chunks = _eob_chunks(last < se - ss, _groups(coded, nb),
                         torch.zeros(r, dtype=torch.int64, device=dev))
    return _cat([
        (zr, _key(zr % nb, ss + cols[zidx], 0, 0), zero_z,
         zero_z + 0xF0, zero_z, zero_z),
        (rows, _key(rows % nb, ss + cols, 1, 0), torch.zeros_like(rows),
         ((run & 15) << 4) | size, extra, size),
        _eob_fields(*chunks[3:], nb)])


def _groups(coded, nb):
    """Stretch number of each row: a new one at every row that emits the
    pending run before its own symbols, and at every image's first block."""
    start = coded.clone()
    start[::nb] = True
    return torch.cumsum(start.to(torch.int64), 0)


def _ac_refine(x, ss, se, al):
    """AC refinement (Ah = Al + 1), one component, as jcphuff.c's
    encode_mcu_AC_refine: per block the band's |coefficient| >> Al, which is
    1 where the coefficient becomes nonzero ("new"), above 1 where it was
    nonzero before ("seen": its correction bit is the value's low bit). Each
    new coefficient is coded (run of zeros, size 1) with its sign bit; a run
    of 16 zeros followed by a later new coefficient is a ZRL, emitted at the
    first nonzero after the zeros; a seen coefficient's bit follows the first
    symbol emitted after it (after the first of several ZRLs, else after a
    new coefficient's sign), or, past the block's last new coefficient, goes
    to the EOB run's buffer."""
    r, nb = x.shape[0] * x.shape[1], x.shape[1]
    dev = x.device
    band = x.reshape(r, 64)[:, ss:se + 1]
    width = se - ss + 1
    a = band.abs() >> al
    new, seen, zero = a == 1, a > 1, a == 0
    pos = torch.arange(width, device=dev).expand(r, -1)
    far = torch.full_like(pos, width)
    zeros_before = torch.cumsum(zero.to(torch.int64), 1) - zero.to(torch.int64)
    # Zeros since the last new coefficient before each position.
    at_new = torch.cummax(torch.where(new, zeros_before, 0), 1).values
    base = torch.cat([torch.zeros_like(at_new[:, :1]), at_new[:, :-1]], 1)
    run = zeros_before - base
    last_new = torch.where(new, pos, -1).amax(1)
    # Every 16th zero of a run that a new coefficient ends starts a ZRL,
    # emitted at the next nonzero.
    zrl = zero & ((run + 1) % 16 == 0) & (pos < last_new[:, None])
    next_nz = torch.flip(torch.cummin(torch.flip(
        torch.where(zero, far, pos), [1]), 1).values, [1])
    zr, zc = torch.nonzero(zrl, as_tuple=True)
    at = next_nz[zr, zc]
    first_zrl = torch.ones_like(zr, dtype=torch.bool)
    first_zrl[1:] = (zr[1:] != zr[:-1]) | (at[1:] != at[:-1])
    n_zrl = torch.zeros(r, width + 1, dtype=torch.int64, device=dev)
    n_zrl.index_put_((zr, at), torch.ones_like(zr), accumulate=True)
    n_zrl = n_zrl[:, :width]
    fire = new | (n_zrl > 0)
    next_fire = torch.flip(torch.cummin(torch.flip(
        torch.where(fire, pos, far), [1]), 1).values, [1])
    target = torch.cat([next_fire[:, 1:], far[:, :1]], 1)
    # Seen coefficients' bits: after a symbol of this block, or buffered.
    br, bc = torch.nonzero(seen & (target < width), as_tuple=True)
    tq = target[br, bc]
    after_zrl = n_zrl[br, tq] > 0
    tail = seen & (target == width)
    w = tail.sum(1)
    inc = last_new < width - 1
    rows, run_of, rank, length, emit_row = _eob_chunks(
        inc, _groups(new.any(1), nb), w)
    tr, tc = torch.nonzero(tail, as_tuple=True)
    at_run = torch.zeros(r, dtype=torch.int64, device=dev)
    at_run[rows] = run_of
    at_rank = torch.zeros(r, dtype=torch.int64, device=dev)
    at_rank[rows] = rank
    order = torch.cumsum(tail.to(torch.int64), 1) - tail.to(torch.int64)
    tr_emit = emit_row[at_run[tr]]
    nr, nc = torch.nonzero(new, as_tuple=True)
    zero_z, zero_n = torch.zeros_like(zr), torch.zeros_like(nr)
    ones_b, ones_t = torch.ones_like(br), torch.ones_like(tr)
    return _cat([
        (zr, _key(zr % nb, ss + at, torch.where(first_zrl, 0, 2), 0), zero_z,
         zero_z + 0xF0, zero_z, zero_z),
        (nr, _key(nr % nb, ss + nc, 3, 0), zero_n,
         ((run[nr, nc] & 15) << 4) | 1, (band[nr, nc] > 0).to(torch.int64),
         zero_n + 1),
        (br, _key(br % nb, ss + tq, torch.where(after_zrl, 1, 3),
                  torch.where(after_zrl, bc, bc + 1)), -ones_b,
         0 * ones_b, a[br, bc] & 1, ones_b),
        _eob_fields(length, emit_row, nb),
        (tr_emit, _key(tr_emit % nb, 64, 1, at_rank[tr] + order[tr, tc]),
         -ones_t, 0 * ones_t, a[tr, tc] & 1, ones_t)])


def _cat(parts):
    return tuple(torch.cat(p) for p in zip(*parts))


def streams(coefs: torch.Tensor, height: int, width: int, quality: int,
            subsampling: str = "420") -> list[tuple[bytes, int]]:
    """(K, n_mcu, h * v + 2, 64) quantized coefficients of K images of one
    shape -> K progressive JFIF streams (SOF2; before each of SCRIPT's scans
    a DHT of each table it codes with, then its SOS), each with its
    entropy-coded bytes (all scans)."""
    k = coefs.shape[0]
    dev = coefs.device
    comps = component_blocks(coefs, height, width, subsampling)
    n_scan = len(SCRIPT)
    parts = []
    for s, (cs, ss, se, ah, al) in enumerate(SCRIPT):
        if ss == 0:
            nb = coefs[0, ..., 0].numel()
            row, key, slot, sym, extra, elen = (
                _dc_first if ah == 0 else _dc_refine)(coefs, al)
        else:
            x = comps[cs[0]]
            nb = x.shape[1]
            row, key, slot, sym, extra, elen = (
                _ac_first if ah == 0 else _ac_refine)(x, ss, se, al)
            # Cb and Cr are coded with the AC table of slot 1.
            slot = torch.where(slot >= 0, slot + int(cs[0] > 0), -1)
        seg = row // nb * n_scan + s
        parts.append((seg, key, torch.where(slot >= 0, seg * 2 + slot, -1),
                      sym, extra, elen))
    seg, key, tab, sym, extra, elen = _cat(parts)
    # A DC scan has the most blocks: every key lies below this one.
    span = _key(coefs[0, ..., 0].numel(), 0, 0, 0)
    fields = P.Fields(seg, seg * span + key, tab, sym, extra, elen)
    counts = P.histograms(tab, sym, 2 * k * n_scan)
    specs = [P.optimal_table(c) if c.any() else None for c in counts]
    coded = P.place(fields, *P._code_tensors(specs, dev), k * n_scan)
    out = []
    for i in range(k):
        body = [P.frame_header(width, height, quality, subsampling, 0xC2)]
        for s, (cs, ss, se, ah, al) in enumerate(SCRIPT):
            t = 2 * (i * n_scan + s)
            cls = int(ss > 0)
            for slot in (0, 1):
                if specs[t + slot] is not None:
                    body.append(P.dht(cls, slot, specs[t + slot]))
            # Table selectors: the slot for the class the scan codes with,
            # 0 for the other and for DC refinement, as libjpeg writes them.
            sel = [int(c > 0) if cls or ah == 0 else 0 for c in cs]
            body.append(P.sos([(c + 1, 0 if cls else t_, t_ if cls else 0)
                               for c, t_ in zip(cs, sel)], ss, se, ah, al))
            body.append(coded[i * n_scan + s])
        body.append(b"\xff\xd9")
        out.append((b"".join(body),
                    sum(len(coded[i * n_scan + s]) for s in range(n_scan))))
    return out
