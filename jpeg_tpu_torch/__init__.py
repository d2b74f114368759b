"""jpeg_tpu_torch: the tpu-jpeg engine ported to PyTorch and CUDA (Hopper).

The JAX package `jpeg_tpu` stays the reference. This package carries every
single-device entry point of it: encode() and decode() for one image,
encode_batched() and decode_batched() for K images of one geometry as one
batch, encode_stream() and decode_stream() for a stream of images of any
sizes with several in flight on CUDA streams, encode_noninterleaved()
(three scans) and models.progressive_enc.encode_progressive() (SOF2).
Underneath: the exact integer transform as one f32 matmul; the level-1
Huffman packer, the dequant + IDCT, the DCT + quantize and the three device
Huffman decoders (AC decode at known block starts, a walk per restart
segment, block starts without restart markers) as hand-written CUDA kernels
(jpeg_tpu_torch/csrc); the sparse coefficient upload with its densify on the
device; and its own copies of the framework-free host modules
(JFIF, BMP, Huffman tables, the NumPy scan walkers and packers, the binding
of the native C++ entropy runtime). It imports torch and numpy, never jax.
"""

from jpeg_tpu_torch.config import EncodeConfig, Subsampling  # noqa: F401
from jpeg_tpu_torch.models.decoder import (  # noqa: F401
    YCbCrPlanes, decode, decode_batched, finish_ycbcr,
)
from jpeg_tpu_torch.models.encoder import (  # noqa: F401
    encode, encode_batched, encode_bmp_to_jpeg, encode_rgb_to_jpeg,
)
from jpeg_tpu_torch.models.multiscan import (  # noqa: F401
    encode_noninterleaved,
)
from jpeg_tpu_torch.parallel.pipeline import (  # noqa: F401
    decode_stream, encode_stream,
)

__version__ = "0.1.0"
