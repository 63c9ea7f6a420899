"""Layers of the port (``repro.models.layers`` counterpart)."""
