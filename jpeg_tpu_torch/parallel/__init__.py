"""The serving and multi-device layers over the single-image entry points:
the streaming encoder and decoder (pipeline), and the (batch, mcu) mesh
layer of jpeg_tpu.parallel: mesh (Mesh, make_mesh, make_multihost_mesh
over the ranks of a torch.distributed process group, to_host, the ppermute
and psum of the per-stripe programs), shard (the per-stripe programs),
batch (encode_batch, decode_batch) and mosaic (encode_mosaic,
encode_mosaic_stream, assemble_tiles).
"""

from jpeg_tpu_torch.parallel.batch import (  # noqa: F401
    decode_batch, encode_batch, tables_from_histograms,
)
from jpeg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, make_multihost_mesh, to_host,
)
from jpeg_tpu_torch.parallel.mosaic import (  # noqa: F401
    assemble_tiles, encode_mosaic, encode_mosaic_stream,
)
from jpeg_tpu_torch.parallel.pipeline import (  # noqa: F401
    decode_stream, encode_stream,
)
