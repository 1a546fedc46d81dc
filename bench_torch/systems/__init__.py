"""Bindings of the program's entries, one module a system, named by a
configuration's `system`."""
