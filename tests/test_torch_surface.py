"""jpeg_tpu_torch's public surface against jpeg_tpu's, read from the source
(an AST walk of both packages; nothing is imported, jax least of all).

Every public top-level def and class of jpeg_tpu/<path>.py has a
counterpart in jpeg_tpu_torch/<path>.py, under the same name or under the
one RENAMED gives, or is named in NOT_PORTED with the reason. Every argument
of a shared function is there too (or named in NOT_PORTED as
"function(argument=)") and keeps the reference's default, except where
DEFAULTS_DIFFER says why. Arguments the port adds are the ones of
PORT_ONLY_ARGUMENTS. NOT_PORTED is the list under "Not ported" in
ROADMAP.md, entry for entry."""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# jpeg_tpu name -> why the port has no counterpart. ROADMAP.md lists the
# same names.
NOT_PORTED = {
    "jpeg_tpu.ops.bitpack.build_bitfields":
        "the TPU packer's field records; kernel A packs straight from blocks",
    "jpeg_tpu.ops.bitpack.pack_bits":
        "the TPU packer's two-level word assembly; kernel A + pack_level2",
    "jpeg_tpu.ops.bitpack.pack_bits_tree":
        "the TPU packer's three-level form; kernel A + pack_level2",
    "jpeg_tpu.ops.bitpack.pack_blocks_tree":
        "the TPU packer's fused tree form; kernel A + pack_level2",
    "jpeg_tpu.ops.bitpack.concat_bitstreams_tree":
        "the TPU packer's scatter-free level 2; pack_level2 places words",
    "jpeg_tpu.models.encoder.device_pack_retry":
        "the TPU packer's scale-2/4 budget ladder; one packer, one spill rule",
    "jpeg_tpu.parallel.mesh.host_to_global":
        "a jax.device_put across processes; shard uploads per rank",
    "jpeg_tpu.entropy.decode_device.densify_body(formulation=)":
        "three TPU formulations of one densify; the port places values",
    "jpeg_tpu.ops.fused.fused_dct_quantize(interpret=)":
        "Pallas interpret mode; a CPU tensor runs the plain twin",
    "jpeg_tpu.ops.fused.fused_dequant_idct(interpret=)":
        "Pallas interpret mode; a CPU tensor runs the plain twin",
    "jpeg_tpu.utils.metrics.StageTimer":
        "a host wall clock around enqueues; the port's stages are spans",
}

# jpeg_tpu name -> the port's name for the same function.
RENAMED = {
    "jpeg_tpu.ops.pack_pallas.pack_level1_pallas":
        "jpeg_tpu_torch.ops.pack.pack_level1",
    "jpeg_tpu.ops.pack_pallas.pack_level2": "jpeg_tpu_torch.ops.pack.pack_level2",
}

# "function(argument=)" -> why the port's default differs.
DEFAULTS_DIFFER = {
    "jpeg_tpu.models.decoder.decode(use_pallas=)":
        "True: kernel B stays on the main path; False is jpeg_tpu's form",
}

# Arguments only the port has, and why.
PORT_ONLY_ARGUMENTS = {
    "device": "where the tensors live; \"cuda\" unless the caller says so",
    "devices": "a mesh's positions, which may repeat a device",
    "mesh": "the collectives of a mesh across processes",
    "backend": "the torch.distributed backend of a multi-process mesh",
}


def _public_defs(root: pathlib.Path) -> dict:
    """{module path without suffix: {name: ast node}} of the public
    top-level defs and classes under root."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        mod = path.relative_to(root).with_suffix("").as_posix()
        tree = ast.parse(path.read_text())
        out[mod] = {n.name: n for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and not n.name.startswith("_")}
    return out


def _arguments(fn: ast.FunctionDef) -> dict:
    """{argument name: its default as source text, or None}."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {arg.arg: None for arg in pos + a.kwonlyargs}
    for arg, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[arg.arg] = ast.unparse(default)
    for arg, default in zip(a.kwonlyargs, a.kw_defaults):
        if default is not None:
            out[arg.arg] = ast.unparse(default)
    return out


REFERENCE = _public_defs(REPO / "jpeg_tpu")
PORT = _public_defs(REPO / "jpeg_tpu_torch")


def _dotted(package: str, mod: str, name: str) -> str:
    return ".".join([package, *mod.split("/"), name])


def _port_def(dotted: str):
    mod, _, name = dotted.removeprefix("jpeg_tpu_torch.").rpartition(".")
    return PORT.get(mod.replace(".", "/"), {}).get(name)


@pytest.mark.parametrize("mod", sorted(m for m, d in REFERENCE.items() if d))
def test_module_surface(mod):
    for name, ref in REFERENCE[mod].items():
        full = _dotted("jpeg_tpu", mod, name)
        if full in NOT_PORTED:
            continue
        ported = _port_def(RENAMED.get(full, _dotted("jpeg_tpu_torch", mod,
                                                      name)))
        assert ported is not None, f"{full} has no counterpart in the port"
        assert type(ported) is type(ref), full
        if not isinstance(ref, ast.FunctionDef) or full in RENAMED:
            continue
        ref_args, port_args = _arguments(ref), _arguments(ported)
        for arg, default in ref_args.items():
            key = f"{full}({arg}=)"
            if key in NOT_PORTED:
                assert arg not in port_args, f"{key} is ported after all"
                continue
            assert arg in port_args, f"{key} is missing in the port"
            if key in DEFAULTS_DIFFER:
                assert port_args[arg] != default, f"{key}: listed, same"
            else:
                assert port_args[arg] == default, (
                    f"{key}: the port's default is {port_args[arg]}, "
                    f"jpeg_tpu's {default}")
        for arg in set(port_args) - set(ref_args):
            assert arg in PORT_ONLY_ARGUMENTS, f"{full}: port-only {arg!r}"
            if arg == "device":
                assert port_args[arg] == "'cuda'", f"{full}: device default"


def test_not_ported_names_exist_only_in_the_reference():
    for key in NOT_PORTED:
        name, _, arg = key.partition("(")
        mod, _, fn = name.removeprefix("jpeg_tpu.").rpartition(".")
        ref = REFERENCE[mod.replace(".", "/")][fn]
        if arg:
            assert arg.removesuffix("=)") in _arguments(ref), key
        else:
            assert _port_def(_dotted("jpeg_tpu_torch", mod.replace(".", "/"),
                                     fn)) is None, f"{key} is ported"
    for key in DEFAULTS_DIFFER:
        name, _, arg = key.partition("(")
        mod, _, fn = name.removeprefix("jpeg_tpu.").rpartition(".")
        assert arg.removesuffix("=)") in _arguments(
            REFERENCE[mod.replace(".", "/")][fn]), key


def test_renamed_counterparts_exist():
    for ref, port in RENAMED.items():
        mod, _, name = ref.removeprefix("jpeg_tpu.").rpartition(".")
        assert name in REFERENCE[mod.replace(".", "/")], ref
        assert isinstance(_port_def(port), ast.FunctionDef), port


def test_not_ported_matches_roadmap():
    """ROADMAP.md's "Not ported" list names exactly NOT_PORTED's entries,
    each as `jpeg_tpu.<module>.<name>` or `...<name>(<argument>=)`."""
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**Not ported.**")
    end = text.index("\n###", start)
    listed = re.findall(r"`(jpeg_tpu\.[\w.]+(?:\(\w+=\))?)`", text[start:end])
    assert len(listed) == len(set(listed)), "a name is listed twice"
    assert set(listed) == set(NOT_PORTED)


def test_ops_package_names_its_submodules():
    """jpeg_tpu_torch/ops/__init__.py imports the submodules that
    jpeg_tpu/ops/__init__.py imports."""
    def imported(path):
        tree = ast.parse(path.read_text())
        return {a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                for a in n.names}

    ref = imported(REPO / "jpeg_tpu" / "ops" / "__init__.py")
    assert ref == {"color", "dct", "dpcm", "quant", "subsample", "tile",
                   "zigzag"}
    assert imported(REPO / "jpeg_tpu_torch" / "ops" / "__init__.py") == ref
