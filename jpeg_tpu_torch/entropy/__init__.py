"""Entropy coding: Huffman tables and the native C++ runtime binding."""
