"""Serving layers over the single-image entry points: the streaming
encoder and decoder (pipeline). The multi-device layers of jpeg_tpu.parallel
(mesh, shard, batch, mosaic) are not ported yet (ROADMAP.md Queue 1 item 7).
"""

from jpeg_tpu_torch.parallel.pipeline import (  # noqa: F401
    decode_stream, encode_stream,
)
