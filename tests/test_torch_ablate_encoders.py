"""scripts/ablate_encoders.py without a card: its variants apply to this
tree's kernel sources, and every TPU encoder probe of K1 and K5 is named
by one of them.  The timings themselves run only on
the card (`python3 scripts/ablate_encoders.py`)."""

import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "ablate_encoders.py")


def _script():
    spec = importlib.util.spec_from_file_location("ablate_encoders", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


A = _script()


@pytest.mark.parametrize("variant", [*A.VARIANTS, A.OP_COSTS])
def test_variant_applies_to_this_tree(variant, tmp_path):
    """Each old text of one alternative is in the kernel source exactly
    once, and patch_tree applies the variant to a copy of the package."""
    if variant == A.OP_COSTS:
        src = open(os.path.join(ROOT, "scripts", "op_costs.cu")).read()
        assert "OP_API int op_cost_ns(int op, int n, float* ns)" in src
        enum = re.search(r"enum Op \{([^}]*)\}", src).group(1)
        assert len(enum.split(",")) == len(A.OPS)
        return
    if variant == "baseline":
        assert A.VARIANTS[variant] == {}
        return
    for src, alternatives in A.VARIANTS[variant].items():
        text = open(os.path.join(ROOT, "huffman_tpu_torch", "csrc",
                                 src)).read()
        assert any(all(text.count(old) == 1 for old, _ in pairs)
                   for pairs in alternatives), f"{variant}: {src}"
    applied = A.patch_tree(ROOT, str(tmp_path), variant)
    assert applied and all(applied.values())
    for src in applied:
        patched = open(os.path.join(tmp_path, "huffman_tpu_torch", "csrc",
                                    src)).read()
        assert patched != open(os.path.join(ROOT, "huffman_tpu_torch",
                                            "csrc", src)).read()


# the TPU probes under experiments/ that K1 and K5 stand for: the eight of
# the variants and the two of op_costs
K1_PROBES = {
    "probe_gather.py:42", "probe_gather.py:71", "profile_levels.py:25",
    "probe_head_ablate.py:30", "probe_dense_ablate.py:30",
    "probe_merge_ops.py:30", "probe_finish32.py:22", "probe_quad16.py:165",
    "probe_ops.py:14", "probe_op_costs.py:13",
}


def test_every_k1_probe_is_named_by_a_variant():
    named = {p for ps in A.STANDS_FOR.values() for p in ps}
    assert K1_PROBES <= named, K1_PROBES - named
    assert set(A.STANDS_FOR) == {*A.VARIANTS, A.OP_COSTS}
    for p in named:
        name, line = p.split(":")
        src = open(os.path.join(ROOT, "experiments", name)).read()
        assert src.splitlines()[int(line) - 1].startswith("def "), p
        assert name in A.__doc__, p
