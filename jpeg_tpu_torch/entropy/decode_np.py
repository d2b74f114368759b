"""Scan-decode error type shared with the native runtime binding.

The JAX package's decode_np also holds a NumPy Huffman decoder; the port
decodes entropy with the native runtime only, so only the error type is
carried over.
"""

from __future__ import annotations


class ScanDecodeError(ValueError):
    pass
