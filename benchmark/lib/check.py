"""The comparison that decides `correct`: the answers kept from the window
against the plain reference (lib/plainjpeg), which works every answer out
again from the cell's own inputs.

- A decoded image: the number of its RGB bytes that lie outside the bounds
  within which every decode of the stream's coefficients that keeps the
  float32 contract lies ("px_outside", summed over the images;
  plainjpeg.pixel_bounds). A shape that differs counts every byte.
- An encoded stream: its header must state the frame, sampling, tables and
  scan that the configuration asks for, and its scan must equal the
  reference's byte for byte ("scan_mismatch", the number of streams that
  fail either).

Each number is held to the limit that the cell's traffic file gives it.
"""

from __future__ import annotations

import numpy as np
import torch

from lib import plainjpeg as P


def _tensor(frame, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(frame), device=device)[None]


def reference_bounds(frame, quality: int, device,
                     subsampling: str = "420") -> tuple:
    """The (lo, hi) bounds of a sound decode of the stream made from
    `frame`, on the host."""
    h, w = frame.shape[:2]
    coefs = P.coefficients(_tensor(frame, device), quality,
                           subsampling=subsampling)[0]
    lo, hi = P.pixel_bounds(coefs, quality, h, w, subsampling=subsampling)
    return lo.cpu().numpy(), hi.cpu().numpy()


def control_pixels(frame, quality: int, device,
                   subsampling: str = "420") -> np.ndarray:
    """The control's decode: the reference with TF32 operands."""
    h, w = frame.shape[:2]
    coefs = P.coefficients(_tensor(frame, device), quality,
                           subsampling=subsampling)[0]
    return P.pixels(coefs, quality, h, w, "tf32", subsampling).cpu().numpy()


def reference_stream(frame, quality: int, device, precision: str = "exact",
                     subsampling: str = "420",
                     restart_interval: int = 0) -> bytes:
    """The reference encode of `frame` (a whole JFIF stream)."""
    h, w = frame.shape[:2]
    coefs = P.coefficients(_tensor(frame, device), quality, precision,
                           subsampling)
    return (P.jfif_header(w, h, quality, subsampling, restart_interval)
            + P.scans(coefs, restart_interval)[0] + b"\xff\xd9")


def _as_host(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def px_outside(out, bounds: tuple) -> int:
    lo, hi = bounds
    out = _as_host(out)
    if out.shape != lo.shape or out.dtype != lo.dtype:
        return int(lo.size)
    return int(np.count_nonzero((out < lo) | (out > hi)))


def stream_faults(data: bytes, ref: bytes) -> int:
    """0 where `data` states what `ref` states (frame size, components and
    their sampling and tables, the quantization and Huffman tables they
    use, the scan's components) and carries the same scan bytes; else 1."""
    try:
        a, b = P.parse(data), P.parse(ref)
    except (ValueError, IndexError, KeyError):
        return 1
    if (a["width"], a["height"], a["restart"]) != (
            b["width"], b["height"], b["restart"]):
        return 1
    if len(a["components"]) != len(b["components"]):
        return 1
    for ca, cb in zip(a["components"], b["components"]):
        if ca[1:3] != cb[1:3] or a["qtables"].get(ca[3]) != b["qtables"][cb[3]]:
            return 1
    scan_a = {c[0]: c for c in a["scan_components"]}
    for ca, cb in zip(a["components"], b["components"]):
        sa = scan_a.get(ca[0])
        sb = next(c for c in b["scan_components"] if c[0] == cb[0])
        if sa is None or a["htables"].get((0, sa[1])) != b["htables"][(0, sb[1])] \
                or a["htables"].get((1, sa[2])) != b["htables"][(1, sb[2])]:
            return 1
    return int(a["scan"] != b["scan"])


def compare(kept, inp, config: dict, device, control: bool = False) -> dict:
    """{number: value} over the kept answers (kind, input index, output).

    control=True puts the reference, in the precision below the stated one,
    in the program's place: the same inputs, answered by plainjpeg's "tf32"
    decode and "float32" encode."""
    q = config["quality"]
    sub, rst = config["subsampling"], config.get("restart_interval", 0)
    refs: dict = {}
    numbers: dict = {}
    for kind, idx, out in kept:
        frame = inp.frames[idx]
        if (kind, idx) not in refs:
            refs[(kind, idx)] = (
                reference_bounds(frame, q, device, sub) if kind == "decode"
                else reference_stream(frame, q, device, "exact", sub, rst))
        ref = refs[(kind, idx)]
        if kind == "decode":
            if control:
                out = control_pixels(frame, q, device, sub)
            numbers["px_outside"] = numbers.get("px_outside", 0) + px_outside(
                out, ref)
        else:
            if control:
                out = reference_stream(frame, q, device, "float32", sub, rst)
            numbers["scan_mismatch"] = numbers.get("scan_mismatch", 0) + (
                stream_faults(out, ref))
    return numbers


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = bool(numbers) and all(v <= limits[k] for k, v in numbers.items())
    return ok, shown
