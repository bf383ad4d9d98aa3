"""Distributed parts of `incubate`: the MoE dispatch (expert-parallel
degree 1)."""
