"""scripts/ablate_hist.py without a card: its kernel variants apply to this
tree's histogram source, its PyTorch forms of the TPU formulations count
exactly on the CPU, and it names the two TPU histogram probes.  The
timings themselves run only on the card (`python3 scripts/ablate_hist.py`)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "ablate_hist.py")


def _script():
    spec = importlib.util.spec_from_file_location("ablate_hist", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


A = _script()

# the TPU histogram formulations that no path of the port runs
HIST_PROBES = {"probe_hist.py:63", "probe_hist.py:69"}


def _source(root):
    return open(os.path.join(root, "huffman_tpu_torch", "csrc",
                             "histogram.cu")).read()


@pytest.mark.parametrize("variant", list(A.VARIANTS))
def test_variant_applies_to_this_tree(variant, tmp_path):
    """Each old text of the variant's one alternative is in histogram.cu
    exactly once, and patch_tree applies the variant to a copy of the
    package."""
    if variant == "baseline":
        assert A.VARIANTS[variant] == {}
        return
    assert set(A.VARIANTS[variant]) == {"histogram.cu"}
    (pairs,) = A.VARIANTS[variant]["histogram.cu"]
    text = _source(ROOT)
    assert all(text.count(old) == 1 for old, _ in pairs), variant
    applied = A.patch_tree(ROOT, str(tmp_path), variant)
    assert applied == {"histogram.cu": True}
    patched = _source(tmp_path)
    assert patched != text
    assert all(new in patched for _, new in pairs)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_byte"])
@pytest.mark.parametrize("form", ["onehot", "ata_i8"])
def test_tpu_formulation_counts_exactly_on_cpu(form, kind):
    """The tensor-core forms give torch.bincount's counts, at small tiles
    (the card's are the same code at larger ones)."""
    rng = np.random.default_rng(5)
    n = 1 << 14
    data = {"uniform": rng.integers(0, 256, n),
            "skewed": rng.geometric(0.45, n) % 256,
            "one_byte": np.full(n, 255)}[kind].astype(np.uint8)
    t = torch.from_numpy(data)
    got = (A.onehot_hist(t, 1 << 12) if form == "onehot"
           else A.ata_hist(t, 1 << 10))
    assert torch.equal(got, torch.bincount(t, minlength=256))


def test_every_hist_probe_is_named_by_a_variant():
    named = {p for ps in A.STANDS_FOR.values() for p in ps}
    assert named == HIST_PROBES
    assert set(A.STANDS_FOR) == set(A.VARIANTS) | set(A.extras())
    for p in named:
        name, line = p.split(":")
        src = open(os.path.join(ROOT, "experiments", name)).read()
        assert src.splitlines()[int(line) - 1].lstrip().startswith("def "), p
        assert p in A.__doc__, p


def test_exact_variants_are_variants():
    assert A.EXACT <= set(A.VARIANTS)
    assert "baseline" in A.EXACT
    assert "read_only" not in A.EXACT
    for name in [*A.VARIANTS, *A.extras()]:
        assert f"  {name} " in A.__doc__, name
