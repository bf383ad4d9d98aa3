"""The serving engine's program budget (`registry.py`)."""
