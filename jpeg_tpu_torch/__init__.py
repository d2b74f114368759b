"""jpeg_tpu_torch: the tpu-jpeg engine ported to PyTorch and CUDA (Hopper).

The JAX package `jpeg_tpu` stays the reference. This package carries
single-image encode() and decode(): the exact integer transform as one f32
matmul; the level-1 Huffman packer, the dequant + IDCT and the DCT + quantize
as hand-written CUDA kernels (jpeg_tpu_torch/csrc); the sparse coefficient
upload with its densify on the device; and its own copies of the
framework-free host modules (JFIF, BMP, Huffman tables, the NumPy scan
walkers, the binding of the native C++ entropy runtime). It imports torch and
numpy, never jax.
"""

from jpeg_tpu_torch.config import EncodeConfig, Subsampling  # noqa: F401
from jpeg_tpu_torch.models.decoder import (  # noqa: F401
    YCbCrPlanes, decode, finish_ycbcr,
)
from jpeg_tpu_torch.models.encoder import (  # noqa: F401
    encode, encode_bmp_to_jpeg, encode_rgb_to_jpeg,
)

__version__ = "0.1.0"
