"""The wide format's specification: huffman_tpu/golden/wide_codec.py.

One oracle, not a copy: this module loads that file by path (it imports
only numpy) and re-exports it, without importing the huffman_tpu package,
whose __init__ imports jax.  The spec: tiles of TILE_BYTES bytes, N_SUB
substreams of SUB_BYTES bytes each, a reader of ROUNDS rounds that pulls
one word pair per substream while avail < THRESH (and below what the
remaining symbols can need) and decodes SPR symbols a round.
"""

from __future__ import annotations

import importlib.util
import os

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "huffman_tpu", "golden",
                      "wide_codec.py")

_spec = importlib.util.spec_from_file_location(
    "huffman_tpu_torch.golden._wide_spec", SOURCE)
_spec_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spec_mod)

TILE_BYTES = _spec_mod.TILE_BYTES
SUB_BYTES = _spec_mod.SUB_BYTES
N_SUB = _spec_mod.N_SUB
MAXLEN = _spec_mod.MAXLEN
SPR = _spec_mod.SPR
ROUNDS = _spec_mod.ROUNDS
THRESH = _spec_mod.THRESH
encode_tile = _spec_mod.encode_tile
decode_tile = _spec_mod.decode_tile
encode = _spec_mod.encode
decode = _spec_mod.decode

__all__ = ["TILE_BYTES", "SUB_BYTES", "N_SUB", "MAXLEN", "SPR", "ROUNDS",
           "THRESH", "encode_tile", "decode_tile", "encode", "decode",
           "SOURCE"]
