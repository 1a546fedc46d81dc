"""One module a byte profile, found by a traffic file's `profile`:
generators/<profile>.py holds generate(traffic, seed, device), which
draws traffic["bytes"] uint8 bytes on `device` from the seed."""
