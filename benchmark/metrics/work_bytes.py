"""The work a decode or an encode needs, in bytes, from the inputs' shapes
and scans alone, and the card's peak bandwidth: the yardstick of the
roofline shares. A later kernel that fuses or renames work is judged on the
same bytes."""

from lib.plainjpeg import SAMPLING

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 bandwidth (at 700 W).
PEAK_BYTES_PER_S = 3.35e12
# One 8x8 block of coefficients as int16.
COEF_BYTES_PER_BLOCK = 128
# One RGB pixel as uint8.
RGB_BYTES_PER_PIXEL = 3


def blocks(width: int, height: int, subsampling: str) -> int:
    """8x8 blocks of a scan at `subsampling`: h * v + 2 per 8h x 8v MCU,
    edges padded."""
    h, v = SAMPLING[subsampling]
    return -(-width // (8 * h)) * -(-height // (8 * v)) * (h * v + 2)


def blocks_420(width: int, height: int) -> int:
    """8x8 blocks of a 4:2:0 scan: six per 16x16 MCU, edges padded."""
    return blocks(width, height, "420")


def entropy_bytes(scan_bytes: int, blocks: int) -> int:
    """Huffman decode: the scan read once, the coefficients written once."""
    return scan_bytes + COEF_BYTES_PER_BLOCK * blocks


def finish_bytes(blocks: int, pixels: int) -> int:
    """IDCT + finish: the coefficients read once, the RGB image written once."""
    return COEF_BYTES_PER_BLOCK * blocks + RGB_BYTES_PER_PIXEL * pixels


def encode_bytes(pixels: int, scan_bytes: int) -> int:
    """Encode on the card: the RGB image read once, the scan written once."""
    return RGB_BYTES_PER_PIXEL * pixels + scan_bytes


def roofline_pct(nbytes: float, kernel_us: float):
    """Share (%) of the least time the bytes take at peak bandwidth in the
    kernels' measured time; None where no such kernel ran."""
    if kernel_us <= 0:
        return None
    return 100.0 * (nbytes / PEAK_BYTES_PER_S) / (kernel_us * 1e-6)
