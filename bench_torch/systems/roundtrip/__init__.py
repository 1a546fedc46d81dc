"""The roundtrip loop's bindings (loops/roundtrip.py), one a
configuration's `system`: encode(arr) -> (encoded, info), dumps(encoded)
-> bytes, loads(bytes) -> encoded, decode(encoded) -> host uint8 array,
and `devices`, the cards the binding uses."""
