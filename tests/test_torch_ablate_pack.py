"""scripts/ablate_pack.py without a card: its variants apply to this tree's
pack source, and it names the three TPU pack probes.  The timings
themselves run only on the card (`python3 scripts/ablate_pack.py`)."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "ablate_pack.py")


def _script():
    spec = importlib.util.spec_from_file_location("ablate_pack", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


A = _script()

# the TPU functions of the pack that no path runs
PACK_PROBES = {"pallas_pack_v1.py:118", "pallas_pack_v1.py:237",
               "probe_pack_fusion.py:301"}


def _source(root):
    return open(os.path.join(root, "huffman_tpu_torch", "csrc",
                             "pack.cu")).read()


@pytest.mark.parametrize("variant", list(A.VARIANTS))
def test_variant_applies_to_this_tree(variant, tmp_path):
    """Each old text of the variant's one alternative is in pack.cu exactly
    once, and patch_tree applies the variant to a copy of the package."""
    if variant == "baseline":
        assert A.VARIANTS[variant] == {}
        return
    assert set(A.VARIANTS[variant]) == {"pack.cu"}
    (pairs,) = A.VARIANTS[variant]["pack.cu"]
    text = _source(ROOT)
    assert all(text.count(old) == 1 for old, _ in pairs), variant
    applied = A.patch_tree(ROOT, str(tmp_path), variant)
    assert applied == {"pack.cu": True}
    patched = _source(tmp_path)
    assert patched != text
    assert all(new in patched for _, new in pairs)


def test_every_pack_probe_is_named_by_a_variant():
    named = {p for ps in A.STANDS_FOR.values() for p in ps}
    assert named == PACK_PROBES
    assert set(A.STANDS_FOR) == set(A.VARIANTS)
    for p in named:
        name, line = p.split(":")
        src = open(os.path.join(ROOT, "experiments", name)).read()
        assert src.splitlines()[int(line) - 1].startswith("def "), p
        assert p in A.__doc__, p


def test_exact_variants_are_variants():
    assert A.EXACT <= set(A.VARIANTS)
    assert "baseline" in A.EXACT
    assert not A.EXACT & {"copy_only", "no_place", "no_stage"}

