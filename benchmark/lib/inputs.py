"""The cells' inputs, made from --seed on the device in a few large calls.

Content is the gradient + uniform noise of the reference repository's
`bench.make_image` (red across the width, green down the height, blue along
the diagonal, integer noise in [-noise, noise], clipped and truncated to
uint8), with the noise drawn by a torch.Generator on the device. A "frames"
configuration makes one such image and rolls it by k * roll columns for
frame k; a "mix" configuration gives every image a shape from a fixed list
in fixed proportions, in an order drawn from the seed, so every seed does the
same work. The decode cells' streams are written by the benchmark's own
plain encoders, never by the codec under test: baseline with the Annex K.3
tables or, with "optimize_tables", each image's Annex K.2 tables
(lib/plainjpeg); with "progressive", libjpeg's 10-scan progression with each
scan's Annex K.2 tables (lib/plainprogressive).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lib import plainjpeg, plainprogressive
from metrics import work_bytes

# Frames of one shape encoded together (bounds the plain encoder's memory).
_CHUNK = 4


@dataclasses.dataclass
class Inputs:
    """Host copies of the images (uint8 (H, W, 3)) and, when a cell decodes,
    their JFIF streams; per image the work it carries."""

    frames: list
    streams: list
    pixels: list  # width * height of each image
    blocks: list  # 8x8 blocks of the scan at the configuration's sampling
    scan_bytes: list  # entropy-coded bytes of each stream, all its scans
    # (0 without one)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_image(h: int, w: int, noise: int, g: torch.Generator,
               device) -> torch.Tensor:
    """(h, w, 3) uint8 gradient + noise on `device`."""
    yy = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    grad = torch.stack(torch.broadcast_tensors(
        xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)), dim=-1)
    n = torch.randint(-noise, noise + 1, (h, w, 3), generator=g, device=device)
    return torch.clamp(grad + n, 0, 255).to(torch.uint8)


def shape_counts(shapes, n: int) -> list:
    """[(width, height, count)] for n images in the listed percentages
    (largest remainder), summing to n."""
    want = [n * pct / 100.0 for _, _, pct in shapes]
    counts = [int(x) for x in want]
    order = sorted(range(len(shapes)), key=lambda i: counts[i] - want[i])
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return [(w, h, c) for (w, h, _), c in zip(shapes, counts)]


def image_shapes(config: dict, n: int, seed: int) -> list:
    """[(width, height)] of the n distinct images of a configuration."""
    if config["kind"] == "frames":
        return [(config["width"], config["height"])] * n
    mix = [s for w, h, c in shape_counts(config["shapes"], n) for s in [(w, h)] * c]
    perm = np.random.default_rng(int(seed) % (1 << 63)).permutation(n)
    return [mix[i] for i in perm]


def make_images(config: dict, n: int, seed: int, device) -> list:
    """The n distinct images of a configuration as device tensors."""
    g = generator(seed, device)
    noise = config["noise"]
    if config["kind"] == "frames":
        base = make_image(config["height"], config["width"], noise, g, device)
        return [torch.roll(base, k * config["roll"], dims=1) for k in range(n)]
    return [make_image(h, w, noise, g, device)
            for w, h in image_shapes(config, n, seed)]


ANNEX_K3 = "ITU-T T.81 Annex K.3"
ANNEX_K2 = "ITU-T T.81 Annex K.2"

# What the plain encoder and reference implement, and why nothing else: a
# configuration that states anything else, or a key not named here, is
# refused rather than run as something it does not say.
IMPLEMENTED = {
    "subsampling": (plainjpeg.SAMPLING, "the plain codec has 2x2, 2x1 and "
                    "1x1 luma sampling with 1x1 chroma only"),
    "restart_interval": (range(1 << 16), "DRI states it in 16 bits, in MCUs"),
    "optimize_tables": ((False, True), "a boolean: Annex K.2 tables built "
                        "from each scan's own symbol counts"),
    "huffman_tables": ((ANNEX_K3, ANNEX_K2), "the plain encoder writes the "
                       "Annex K.3 tables or builds them by Annex K.2"),
    "progressive": ((False, True), "a boolean: the 10-scan script of libjpeg's "
                    "jpeg_simple_progression"),
    "kind": (("frames", "mix"), "lib/inputs makes rolled frames or a mix of "
             "shapes only"),
}
REQUIRED = {"frames": ("width", "height", "quality", "noise", "roll"),
            "mix": ("shapes", "quality", "noise")}
DESCRIPTIVE = {"name", "source", "precision", "guarantees", "assumed",
               "reduced"}


def check_config(config: dict) -> None:
    """Raise ValueError where `config` states a key or a value that the
    benchmark's inputs and reference do not implement."""
    kind = config.get("kind")
    if kind not in IMPLEMENTED["kind"][0]:
        raise ValueError(f"configuration kind {kind!r} is not implemented: "
                         f"{IMPLEMENTED['kind'][1]}")
    known = set(IMPLEMENTED) | set(REQUIRED[kind]) | DESCRIPTIVE
    unknown = sorted(set(config) - known)
    if unknown:
        raise ValueError(f"configuration keys not implemented: {unknown}")
    missing = [k for k in REQUIRED[kind] + ("subsampling",) if k not in config]
    if missing:
        raise ValueError(f"configuration lacks {missing}")
    for key, (allowed, why) in IMPLEMENTED.items():
        value = config.get(key)
        # The type check keeps True from passing for 1, and 240.0 for 240.
        if key in config and (type(value) is not type(next(iter(allowed)))
                              or value not in allowed):
            raise ValueError(f"configuration {key}={value!r} is not "
                             f"implemented: {why}")
    optimize = config.get("optimize_tables", False)
    tables = config.get("huffman_tables", ANNEX_K3)
    if optimize != (tables == ANNEX_K2):
        raise ValueError(
            f"configuration optimize_tables={optimize!r} contradicts "
            f"huffman_tables={tables!r}: Annex K.2 tables are the optimized "
            "ones, Annex K.3's the fixed ones")
    if config.get("progressive", False):
        if not optimize:
            raise ValueError(
                "configuration progressive=True needs optimize_tables=true "
                "and Annex K.2 tables: libjpeg builds each progressive scan's "
                "tables from its own counts")
        if config.get("restart_interval", 0):
            raise ValueError(
                f"configuration progressive=True with restart_interval="
                f"{config['restart_interval']!r} is not implemented: the "
                "plain progressive writer codes each scan in one interval")


def build(config: dict, n_frames: int, n_streams: int, seed: int,
          device) -> Inputs:
    """Frames for the encode traffic and streams of the first n_streams
    images for the decode traffic, all on the host."""
    check_config(config)
    imgs = make_images(config, max(n_frames, n_streams), seed, device)
    q = config["quality"]
    sub, rst = config["subsampling"], config.get("restart_interval", 0)
    if config.get("progressive", False):
        def write(coefs, hh, ww):
            return plainprogressive.streams(coefs, hh, ww, q, sub)
    else:
        def write(coefs, hh, ww):
            return plainjpeg.streams(coefs, hh, ww, q, sub, rst,
                                     config.get("optimize_tables", False))
    streams, scan_bytes = [], []
    by_shape: dict = {}
    for i in range(n_streams):
        by_shape.setdefault(tuple(imgs[i].shape), []).append(i)
    out: dict = {}
    for idx in by_shape.values():
        for c in range(0, len(idx), _CHUNK):
            part = idx[c:c + _CHUNK]
            batch = torch.stack([imgs[i] for i in part])
            coefs = plainjpeg.coefficients(batch, q, subsampling=sub)
            for i, made in zip(part, write(coefs, *batch.shape[1:3])):
                out[i] = made
    for i in range(n_streams):
        streams.append(out[i][0])
        scan_bytes.append(out[i][1])
    frames = [im.cpu().numpy() for im in imgs]
    shapes = [(f.shape[1], f.shape[0]) for f in frames]
    return Inputs(
        frames=frames, streams=streams,
        pixels=[w * h for w, h in shapes],
        blocks=[work_bytes.blocks(w, h, sub) for w, h in shapes],
        scan_bytes=scan_bytes + [0] * (len(frames) - n_streams))
