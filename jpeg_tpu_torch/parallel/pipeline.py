"""Streaming encode and decode with several images in flight, so that the
host work of one image (entropy finalize and JFIF assembly on encode, the
Huffman walk on decode) overlaps the device work and the transfers of its
neighbours.

Counterpart of jpeg_tpu/parallel/pipeline.py. Where the reference rides
JAX's asynchronous dispatch, the port keeps each image's device work on one
CUDA stream of a small ring, reads the pack's status back through a pinned
buffer, and waits for one image's event only when that image is finished;
an image goes up from its slot's pinned staging buffer, which the host fills
on several threads. The reference's three dispatch kinds and its retry
ladder of larger pack budgets are not ported: the port has one packer
(kernel A + the scan pass) and one spill rule (an image whose pack
overflows is host-packed, counted in encoder.HOST_PACK_SPILLS).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from jpeg_tpu_torch.config import EncodeConfig
from jpeg_tpu_torch.models import encoder as E
from jpeg_tpu_torch.ops import quant
from jpeg_tpu_torch.utils.trace import span


class _Slot:
    """One place of encode_stream's ring: a CUDA stream, a pinned staging
    buffer for the image, a pinned buffer for what the host reads back
    before the scan (the pass's status, or the symbol histograms) and a
    pinned buffer for the scan's bytes. Each is allocated once (grown when
    an image needs more) and reused by every image that takes the slot: the
    image before has been finished by then."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.staging = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self.readback = None
        self.scan = torch.empty(0, dtype=torch.uint8, pin_memory=True)

    def stage(self, img: np.ndarray) -> torch.Tensor:
        """`img` copied into the pinned buffer, as a tensor view of it.

        The copy runs on torch's intra-op threads with the GIL released: on
        one thread (np.copyto) a 4K frame's copy cost more host time than
        the pageable upload it replaces. torch takes no array with a
        negative stride, and warns on one that is not writable: those are
        copied on this thread."""
        if self.staging.numel() < img.size:
            self.staging = torch.empty(img.size, dtype=torch.uint8,
                                       pin_memory=True)
        view = self.staging[:img.size].view(img.shape)
        if img.flags.writeable and min(img.strides) >= 0:
            view.copy_(torch.from_numpy(img))
        else:
            np.copyto(view.numpy(), img)
        return view

    def fetch(self, t: torch.Tensor) -> torch.Tensor:
        """Start an asynchronous copy of a small device tensor into the
        pinned readback buffer (valid once the current stream gets there)."""
        if self.readback is None or self.readback.shape != t.shape:
            self.readback = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
        self.readback.copy_(t, non_blocking=True)
        return self.readback

    def download(self, scan: torch.Tensor, count: int) -> np.ndarray:
        """The first `count` bytes of the device scan, copied on the slot's
        stream into the slot's pinned buffer once the stream gets there; a
        numpy view of them, valid until the slot's next image."""
        if self.scan.numel() < count:
            self.scan = torch.empty(count, dtype=torch.uint8,
                                    pin_memory=True)
        view = self.scan[:count]
        with torch.cuda.stream(self.stream):
            view.copy_(scan[:count], non_blocking=True)
        self.stream.synchronize()
        return view.numpy()


def encode_stream(
    images: Iterable[np.ndarray],
    quality: int = 75,
    subsampling="420",
    depth: int = 2,
    device_pack: bool | None = None,
    optimize_tables: bool = False,
    device="cuda",
) -> Iterator[bytes]:
    """Encode a stream of RGB images on `device`, keeping up to `depth`
    device encodes in flight while the host finalizes earlier ones. Yields
    JFIF bytes in input order, each equal to encode() of its image. Images
    may vary in size.

    On a card every image has a place in a ring of depth + 1 slots, each
    with a CUDA stream. Dispatch copies the image into the slot's pinned
    buffer (the caller may reuse its array once dispatch returns), uploads
    it from there on the slot's stream and enqueues there, without waiting
    for any of it: edge pad, exact transform, DC DPCM, kernel A, the scan
    pass (placement, padding, stuffing), and a copy of its status to pinned
    memory; then it records an event. Finish waits for that image's event
    only, downloads the scan's bytes on the same stream into the slot's
    pinned buffer and writes the JFIF stream.

    optimize_tables: dispatch enqueues the symbol histograms instead of the
    pack; finish reads them, builds that image's optimal tables and runs the
    pack then, still on the image's stream.

    device_pack=False encodes image by image through the host pack."""
    cfg = EncodeConfig(quality=quality, subsampling=subsampling,
                       optimize_tables=optimize_tables)
    device = torch.device(device)
    if device_pack is None:
        device_pack = True
    depth = max(0, int(depth))
    qy_np = quant.luma_table(cfg.quality)
    qc_np = quant.chroma_table(cfg.quality)
    slots = [_Slot(device) for _ in range(depth + 1)] if (
        device.type == "cuda" and device_pack) else None

    def on_stream(slot):
        return torch.cuda.stream(slot.stream) if slot is not None else (
            contextlib.nullcontext())

    def dispatch(img, index: int):
        img = E._normalize_image(img)  # encode()'s float/dtype convention
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3), got {img.shape}")
        if not device_pack:
            return img
        slot = slots[index % len(slots)] if slots else None
        with span("jt.encode.dispatch"), on_stream(slot):
            if slot is None:
                with span("jt.wait.upload"):
                    dev = torch.as_tensor(np.ascontiguousarray(img),
                                          device=device)
            else:
                # The slot's image before was finished (its event waited
                # for), so its staging buffer is free.
                with span("jt.encode.stage"):
                    dev = slot.stage(img).to(device, non_blocking=True)
            rec = E._enqueue(dev, cfg, qy_np, qc_np)
            host, done = rec.readback, None
            if slot is not None:
                host = slot.fetch(host)
                done = torch.cuda.Event()
                done.record()
        return slot, done, rec, host

    def finish(item) -> bytes:
        if isinstance(item, np.ndarray):
            return E.encode(item, quality, cfg.subsampling,
                            optimize_tables=optimize_tables,
                            device_pack=False, device=device)
        slot, done, rec, host = item
        with span("jt.encode.finish"):
            if done is not None:
                with span("jt.wait.slot"):
                    done.synchronize()
            with on_stream(slot):
                return E._finish(rec, host, fetch=(
                    slot.download if slot is not None else None))

    pending: collections.deque = collections.deque()
    for index, img in enumerate(images):
        pending.append(dispatch(img, index))
        if len(pending) > depth:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())


def decode_stream(
    datas: Iterable[bytes],
    fancy_upsample: bool = True,
    scale_denom: int = 1,
    depth: int = 2,
    entropy: str = "auto",
    device_output: bool = False,
    device="cuda",
) -> Iterator:
    """Decode a stream of JPEGs on `device`, keeping `depth` decodes in
    flight on worker threads, so that the host work of stream i+1 (the parse
    and the unstuffing, or a host Huffman walk where `entropy` asks for one)
    overlaps the device work and the download of stream i. Yields the
    decoded arrays (tensors on `device` with device_output) in input order,
    each equal to decode() of its stream. Streams may differ in geometry,
    sampling and tables: each decode is independent.

    On a card each worker thread owns one CUDA stream and runs the whole of
    a decode on it, the download included; a result crosses to the consumer
    only after that stream is synchronized. A tensor yielded with
    device_output was allocated on a worker's stream: it is recorded on the
    consumer's current stream, so its memory is not reused while that stream
    still reads it. An exception in a worker is raised at that item's
    turn."""
    from concurrent.futures import ThreadPoolExecutor

    from jpeg_tpu_torch.models.decoder import decode

    device = torch.device(device)
    on_card = device.type == "cuda"
    depth = max(1, int(depth))
    local = threading.local()

    def work(data):
        if not on_card:
            return decode(data, fancy_upsample=fancy_upsample, device=device,
                          scale_denom=scale_denom, entropy=entropy,
                          device_output=device_output)
        if not hasattr(local, "stream"):
            local.stream = torch.cuda.Stream(device)
        with torch.cuda.stream(local.stream):
            out = decode(data, fancy_upsample=fancy_upsample, device=device,
                         scale_denom=scale_denom, entropy=entropy,
                         device_output=True)
            with span("jt.wait.stream"):
                if not device_output:
                    return out.cpu().numpy()  # waits for this stream only
                local.stream.synchronize()
            return out

    def result(future):
        out = future.result()
        if on_card and device_output:
            out.record_stream(torch.cuda.current_stream(device))
        return out

    with ThreadPoolExecutor(depth) as pool:
        pending: collections.deque = collections.deque()
        for d in datas:
            pending.append(pool.submit(work, d))
            if len(pending) > depth:
                yield result(pending.popleft())
        while pending:
            yield result(pending.popleft())
