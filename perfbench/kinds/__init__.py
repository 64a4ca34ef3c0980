"""The traffic kinds, one module a kind (perfbench/spec.py::kind_module)."""
