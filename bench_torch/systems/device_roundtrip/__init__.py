"""The card-resident roundtrip loop's bindings (loops/device_roundtrip.py),
one a configuration's `system`: encode(tensor) -> (encoded, info),
dumps(encoded) -> uint8 tensor on the card, loads(tensor) -> encoded,
decode(encoded) -> uint8 tensor on the card, and `devices`, the cards the
binding uses."""
