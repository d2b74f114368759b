"""The PyTorch port's host layer and parameters against the JAX package.

The copied host modules (tables, Huffman, JFIF) and the transform parameters
(mcu_kernel_int, zigzag_qdiv_int, kernel_to_torch) must equal the JAX
package's exactly: tolerance 0 throughout. The port must import and run
where jax cannot be imported (every decode backend and stream type
included), and must refuse an entropy backend it does not know."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpeg_tpu import tables as JT
from jpeg_tpu.config import Subsampling as JS
from jpeg_tpu.entropy import huffman as JH
from jpeg_tpu.io import jfif as JF
from jpeg_tpu.ops import bitpack as JB, color as JC, dct as JD, mcu_conv as JM, quant as JQ

import jpeg_tpu_torch
from jpeg_tpu_torch import tables as PT
from jpeg_tpu_torch.config import Subsampling as PS
from jpeg_tpu_torch.entropy import huffman as PH
from jpeg_tpu_torch.io import jfif as PF
from jpeg_tpu_torch.ops import bitpack as PB, color as PC, dct as PD, mcu_conv as PM, quant as PQ

from torch_port_util import make_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("444", "422", "420")


@pytest.mark.parametrize("name", [
    "QUANT_LUMA", "QUANT_CHROMA", "ZIGZAG_ORDER", "INV_ZIGZAG",
    "DC_LUMA_BITS", "DC_LUMA_VALS", "DC_CHROMA_BITS", "DC_CHROMA_VALS",
    "AC_LUMA_BITS", "AC_LUMA_VALS", "AC_CHROMA_BITS", "AC_CHROMA_VALS",
])
def test_constant_tables_equal(name):
    np.testing.assert_array_equal(getattr(PT, name), getattr(JT, name))


def test_quality_tables_and_constants_equal():
    for q in (1, 10, 50, 75, 95, 100):
        np.testing.assert_array_equal(PQ.luma_table(q), JQ.luma_table(q))
        np.testing.assert_array_equal(PQ.chroma_table(q), JQ.chroma_table(q))
    np.testing.assert_array_equal(PD.dct_basis(), JD.dct_basis())
    for name in ("RGB_TO_YCBCR", "YCBCR_OFFSET", "YCBCR_TO_RGB"):
        np.testing.assert_array_equal(getattr(PC, name), getattr(JC, name))


def test_standard_tables_and_luts_equal():
    pt, jt = PH.standard_tables(), JH.standard_tables()
    assert pt.keys() == jt.keys()
    for k in pt:
        for field in ("bits", "vals", "code", "size"):
            np.testing.assert_array_equal(getattr(pt[k], field),
                                          getattr(jt[k], field))
    for a, b in zip(PB.luts_from_tables(pt), JB.luts_from_tables(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_mcu_kernel_int_and_kernel_to_torch_equal(mode):
    pk, pb = PM.mcu_kernel_int(PS(mode))
    jk, jb = JM.mcu_kernel_int(JS(mode))
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pb, jb)
    # The port's tensors built from the JAX package's arrays equal those
    # built from its own.
    k1, b1 = PM.kernel_to_torch(jk, jb, "cpu")
    k2, b2 = PM.kernel_to_torch(pk, pb, "cpu")
    assert k1.dtype == torch.float32 and b1.dtype == torch.int32
    assert torch.equal(k1, k2) and torch.equal(b1, b2)
    np.testing.assert_array_equal(k1.numpy(), jk.reshape(-1, jk.shape[-1]))
    hv = PS(mode).h_factor * PS(mode).v_factor
    for q in (1, 75, 100):
        qy, qc = JQ.luma_table(q), JQ.chroma_table(q)
        np.testing.assert_array_equal(
            PM.zigzag_qdiv_int(qy, qc, hv),
            np.asarray(JM.zigzag_qdiv_int(jnp.asarray(qy), jnp.asarray(qc), hv)))


def test_jfif_header_bytes_and_parse_equal():
    h = PH.standard_tables()
    comps_p = [PF.ComponentSpec(1, 2, 2, 0, 0, 0), PF.ComponentSpec(2, 1, 1, 1, 1, 1),
               PF.ComponentSpec(3, 1, 1, 1, 1, 1)]
    comps_j = [JF.ComponentSpec(1, 2, 2, 0, 0, 0), JF.ComponentSpec(2, 1, 1, 1, 1, 1),
               JF.ComponentSpec(3, 1, 1, 1, 1, 1)]
    q = {0: JQ.luma_table(80), 1: JQ.chroma_table(80)}
    a = PF.write_jpeg(37, 53, comps_p, q, h, b"\x12\x34", restart_interval=3,
                      comment="port")
    b = JF.write_jpeg(37, 53, comps_j, q, JH.standard_tables(), b"\x12\x34",
                      restart_interval=3, comment="port")
    assert a == b
    pi, ji = PF.parse_jpeg(a), JF.parse_jpeg(a)
    assert (pi.width, pi.height, pi.restart_interval, pi.scan_data) == (
        ji.width, ji.height, ji.restart_interval, ji.scan_data)


def test_port_imports_and_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jpeg_tpu'] = None\n"
        "import numpy as np\n"
        "import jpeg_tpu_torch as P\n"
        "img = (np.arange(24 * 40 * 3) % 251).astype(np.uint8).reshape(24, 40, 3)\n"
        "jpg = P.encode(img, quality=80, device='cpu')\n"
        "out = P.decode(jpg, device='cpu')\n"
        "assert out.shape == (24, 40, 3) and out.dtype == np.uint8\n"
        "gray = P.decode(P.encode(img[..., 1], device='cpu'), device='cpu')\n"
        "assert gray.shape == (24, 40) and gray.dtype == np.uint8\n"
        "opt = P.encode(img, optimize_tables=True, restart_interval=4,\n"
        "               device='cpu')\n"
        "assert P.decode(opt, device='cpu').shape == (24, 40, 3)\n"
        "sp = P.decode(opt, device='cpu', entropy='sparse', scale_denom=2)\n"
        "assert sp.shape == (12, 20, 3)\n"
        "import jpeg_tpu_torch.ops.entropy_decode, jpeg_tpu_torch.parallel\n"
        "for e in ('indexed', 'device'):\n"
        "    for s in (jpg, opt):\n"
        "        assert np.array_equal(P.decode(s, device='cpu', entropy=e),\n"
        "                              P.decode(s, device='cpu'))\n"
        "yc = P.decode(jpg, device='cpu', output='ycbcr')\n"
        "assert np.array_equal(P.finish_ycbcr(yc), out)\n"
        "for name, shape in (('progressive_420.jpg', (131, 203, 3)),\n"
        "                    ('ycck.jpg', (32, 40, 4))):\n"
        "    data = open('tests/data/torch_port/' + name, 'rb').read()\n"
        "    assert P.decode(data, device='cpu', entropy='numpy').shape == shape\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok', len(jpg))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_every_module_of_the_port_imports_without_jax():
    """Each module under jpeg_tpu_torch/ and chip_smoke.py, imported with jax
    and jpeg_tpu blocked: none of them may reach for either."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jpeg_tpu'] = None\n"
        "import jpeg_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    jpeg_tpu_torch.__path__, 'jpeg_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert 'jpeg_tpu_torch.ops.entropy_decode' in names\n"
        "assert 'jpeg_tpu_torch.entropy.decode_device' in names\n"
        "print('ok', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_builds_and_runs_alone(tmp_path):
    """jpeg_tpu_torch/ copied alone (no jpeg_tpu/ beside it, no build
    directory) builds its native runtime from its own csrc/entropy.cc and
    encodes + decodes a 64x48 image on the CPU to the in-tree port's bytes
    and pixels. The copy of entropy.cc is the JAX package's byte for byte."""
    import hashlib
    import shutil

    with open(os.path.join(REPO, "jpeg_tpu_torch", "csrc", "entropy.cc"),
              "rb") as f:
        ours = f.read()
    with open(os.path.join(REPO, "jpeg_tpu", "native", "entropy.cc"),
              "rb") as f:
        assert ours == f.read()
    shutil.copytree(os.path.join(REPO, "jpeg_tpu_torch"),
                    tmp_path / "jpeg_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    assert not (tmp_path / "jpeg_tpu").exists()
    code = (
        "import sys, hashlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jpeg_tpu'] = None\n"
        "import numpy as np\n"
        "import jpeg_tpu_torch as P\n"
        "from jpeg_tpu_torch.entropy import native\n"
        "img = (np.arange(48 * 64 * 3) % 253).astype(np.uint8).reshape(48, 64, 3)\n"
        "jpg = P.encode(img, quality=80, device='cpu', device_pack=False)\n"
        "px = P.decode(jpg, device='cpu', entropy='native')\n"
        "print(P.__file__, native._LIB_PATH, native._SRC)\n"
        "print(hashlib.sha256(jpg).hexdigest(), hashlib.sha256(px.tobytes()).hexdigest())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    where, digests = proc.stdout.strip().splitlines()[-2:]
    pkg, lib, src = where.split()
    for path in (pkg, lib, src):
        assert path.startswith(str(tmp_path)), where
    assert os.path.exists(lib)
    img = (np.arange(48 * 64 * 3) % 253).astype(np.uint8).reshape(48, 64, 3)
    jpg = jpeg_tpu_torch.encode(img, quality=80, device="cpu",
                                device_pack=False)
    px = jpeg_tpu_torch.decode(jpg, device="cpu", entropy="native")
    assert digests.split() == [hashlib.sha256(jpg).hexdigest(),
                               hashlib.sha256(px.tobytes()).hexdigest()]


def test_entry_points_default_to_the_card():
    """Every public function of the port that takes a device runs on "cuda"
    unless the caller says otherwise."""
    import inspect

    from jpeg_tpu_torch.entropy import decode_device

    fns = [getattr(jpeg_tpu_torch, n) for n in (
        "encode", "decode", "encode_batched", "decode_batched",
        "encode_stream", "decode_stream", "encode_noninterleaved")]
    fns += [decode_device.decode_scan, decode_device.decode_scan_indexed,
            decode_device.decode_scan_prefix, decode_device.decode_scan_sparse,
            jpeg_tpu_torch.parallel.encode_mosaic_stream]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("entropy", ["gpu", "Device", ""])
def test_unknown_entropy_backend_is_refused(entropy):
    """decode() knows six backends, all of them ported, and refuses any
    other name before it parses the stream."""
    from jpeg_tpu_torch.models.decoder import ENTROPY_BACKENDS

    assert sorted(ENTROPY_BACKENDS) == sorted(
        ("auto", "native", "numpy", "device", "indexed", "sparse"))
    with pytest.raises(ValueError, match="unknown entropy backend"):
        jpeg_tpu_torch.decode(b"", entropy=entropy, device="cpu")
