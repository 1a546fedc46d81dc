"""scripts/ablate_emit.py without a card: its variants apply to this tree's
schedule and K7 source, it names the TPU probes of K6 and K7, and every TPU
probe under experiments/ is named by some ablation script or is pending.
The timings themselves run only on the card (`python3
scripts/ablate_emit.py`)."""

import glob
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def _load(path):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


A = _load(os.path.join(SCRIPTS, "ablate_emit.py"))

# the TPU functions of K6 and K7 that no path runs
K6_K7_PROBES = {"probe_emit.py:25", "probe_relayout.py:24",
                "probe_relayout.py:129"}
# experiments whose Pallas kernels no ablation script stands for yet: none
PENDING = set()


@pytest.mark.parametrize("variant", list(A.VARIANTS))
def test_variant_applies_to_this_tree(variant, tmp_path):
    """Each old text of the first alternative is in the source exactly
    once, and patch_tree applies the variant to a copy of the package."""
    if variant == "baseline":
        assert A.VARIANTS[variant] == {}
        return
    for src, alternatives in A.VARIANTS[variant].items():
        text = open(os.path.join(ROOT, "huffman_tpu_torch", "csrc",
                                 src)).read()
        assert all(text.count(old) == 1 for old, _ in alternatives[0]), (
            variant, src)
    applied = A.patch_tree(ROOT, str(tmp_path), variant)
    assert applied and all(applied.values())
    for src in applied:
        patched = open(os.path.join(tmp_path, "huffman_tpu_torch", "csrc",
                                    src)).read()
        assert patched != open(os.path.join(ROOT, "huffman_tpu_torch",
                                            "csrc", src)).read()


def test_every_k6_k7_probe_is_named_by_a_variant():
    named = {p for ps in A.STANDS_FOR.values() for p in ps}
    assert named == K6_K7_PROBES
    assert set(A.STANDS_FOR) == set(A.VARIANTS)
    assert A.EXACT <= set(A.VARIANTS)
    for p in named:
        name, line = p.split(":")
        src = open(os.path.join(ROOT, "experiments", name)).read()
        assert src.splitlines()[int(line) - 1].startswith("def "), p
        assert p in A.__doc__, p


def test_every_tpu_probe_is_named_or_pending():
    """Every experiments/*.py that calls pl.pallas_call is named by the
    STANDS_FOR of some scripts/ablate_*.py, or is pending."""
    named = set()
    for path in sorted(glob.glob(os.path.join(SCRIPTS, "ablate_*.py"))):
        for probes in getattr(_load(path), "STANDS_FOR", {}).values():
            named |= {p.split(":")[0] for p in probes}
    pallas = {os.path.basename(p)
              for p in glob.glob(os.path.join(ROOT, "experiments", "*.py"))
              if "pl.pallas_call" in open(p).read()}
    assert pallas - named == PENDING
    assert not PENDING & named
