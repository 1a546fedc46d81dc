"""scripts/ablate_scan.py without a card: each of its kernel variants
applies to this tree's offset scan source, and each is named in its
documentation.  The timings themselves run only on the card
(`python3 scripts/ablate_scan.py`)."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "ablate_scan.py")


def _script():
    spec = importlib.util.spec_from_file_location("ablate_scan", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


A = _script()


def _source(root):
    return open(os.path.join(root, "huffman_tpu_torch", "csrc",
                             "scan.cu")).read()


@pytest.mark.parametrize("variant", list(A.VARIANTS))
def test_variant_applies_to_this_tree(variant, tmp_path):
    """Each old text of the variant's one alternative is in scan.cu exactly
    once, and patch_tree applies the variant to a copy of the package."""
    if variant == "baseline":
        assert A.VARIANTS[variant] == {}
        return
    assert set(A.VARIANTS[variant]) == {"scan.cu"}
    (pairs,) = A.VARIANTS[variant]["scan.cu"]
    text = _source(ROOT)
    assert all(text.count(old) == 1 for old, _ in pairs), variant
    applied = A.patch_tree(ROOT, str(tmp_path), variant)
    assert applied == {"scan.cu": True}
    patched = _source(tmp_path)
    assert patched != text
    assert all(new in patched for _, new in pairs)


def test_exact_variants_are_variants_and_documented():
    assert A.EXACT <= set(A.VARIANTS)
    assert "baseline" in A.EXACT
    assert not {"no_lookback", "no_store"} & A.EXACT
    for name in A.VARIANTS:
        assert f"  {name} " in A.__doc__, name
