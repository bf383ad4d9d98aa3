"""Distributed model pieces: `moe`."""
