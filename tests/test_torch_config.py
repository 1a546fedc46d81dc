"""The port's CodecConfig and Encoded against the JAX package's, and the
dense codec at blocks larger than 4 KiB, on the CPU.

Every knob, property and helper of huffman_tpu.config has the same name,
order, default and value in huffman_tpu_torch.config; api.encode at 8192-
and 262,144-byte blocks gives huffman_tpu.api.encode's stream words and
block bits, and decodes to the input.  Tolerance zero throughout.
"""

import dataclasses

import numpy as np
import pytest

from huffman_tpu import api as ref_api
from huffman_tpu import config as ref_config
from huffman_tpu.config import CodecConfig as RefConfig

from huffman_tpu_torch import api, config
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.utils import testdata

# keyword arguments both packages take, with and without the two knobs
# that steer only the JAX package's Mosaic kernels
KWARGS = [
    {},
    {"block_bytes": 8192, "max_code_len": 14, "table_bits": 16},
    {"block_bytes": 64, "capacity_bits_per_byte": 24, "max_code_len": 24,
     "spec_bits_per_byte": 0, "narrow_tol": 0.0},
    {"table_bits": 12, "spec_bits_per_byte": 6, "check_overflow": False},
]


def test_fields_equal_the_jax_package():
    """Same names, in the same order, with the same defaults: a positional
    argument means the same knob in both packages."""
    ours = [(f.name, f.default) for f in dataclasses.fields(CodecConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(RefConfig)]
    assert ours == ref
    args = (4096, 12, 8, True, 14, 0.5, 2)
    assert dataclasses.asdict(CodecConfig(*args)) == dataclasses.asdict(
        RefConfig(*args))


@pytest.mark.parametrize("name", ["block_words", "capacity_words",
                                  "decode_table_bits"])
@pytest.mark.parametrize("kw", KWARGS)
def test_property_equals_the_jax_package(name, kw):
    assert getattr(CodecConfig(**kw), name) == getattr(RefConfig(**kw), name)


@pytest.mark.parametrize("name", ["padded_bytes", "num_blocks"])
@pytest.mark.parametrize("kw", KWARGS)
def test_method_equals_the_jax_package(name, kw):
    for n in (0, 1, 63, 64, 65, 8191, 8192, 8193, 10**6 + 3):
        assert (getattr(CodecConfig(**kw), name)(n)
                == getattr(RefConfig(**kw), name)(n)), n


@pytest.mark.parametrize("fn", ["round_up", "cdiv"])
def test_helper_equals_the_jax_package(fn):
    for x in (0, 1, 3, 4, 5, 127, 128, 129, 10**9 + 7):
        for m in (1, 4, 128, 1000):
            assert getattr(config, fn)(x, m) == getattr(ref_config, fn)(x, m)


@pytest.mark.parametrize("bad", [
    {"table_bits": 11},                               # below max_code_len 12
    {"max_code_len": 16, "table_bits": 15},
    {"block_bytes": 6}, {"max_code_len": 25},
])
def test_invalid_config_raises_like_the_jax_package(bad):
    with pytest.raises(ValueError) as ref_err:
        RefConfig(**bad)
    with pytest.raises(ValueError) as err:
        CodecConfig(**bad)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("n,nsym", [(10 * 1024 + 77, 32), (5000, 256),
                                    (0, 1)])
def test_encoded_ratio_equals_the_jax_package(n, nsym):
    data = testdata.skewed(n, num_symbols=nsym, seed=n % 7)
    enc = api.encode(data, device="cpu")
    assert enc.ratio == ref_api.encode(data).ratio
    assert enc.ratio == (enc.total_bits / 8) / max(n, 1)


# blocks larger than 4 KiB: the CLI's --block-bytes 8192, and blocks whose
# capacity (65,536 words at 8 bits a byte) is more than a CTA's shared
# memory on the card
@pytest.mark.parametrize("bb,n", [(8192, 3 * 8192 + 1001),
                                  (262144, 262144 + 4099)])
def test_large_blocks_equal_the_jax_package(bb, n):
    data = testdata.skewed(n, num_symbols=40, seed=bb % 11)
    enc = api.encode(data, CodecConfig(block_bytes=bb), device="cpu")
    ref = ref_api.encode(data, RefConfig(block_bytes=bb))
    assert len(enc.block_bits) == config.cdiv(n, bb)
    np.testing.assert_array_equal(enc.codebook.lengths, ref.codebook.lengths)
    np.testing.assert_array_equal(enc.block_bits, ref.block_bits)
    assert enc.total_bits == ref.total_bits
    np.testing.assert_array_equal(enc.stream_words, ref.stream_words)
    np.testing.assert_array_equal(api.decode(enc, device="cpu"), data)
