"""Backbones (port of ``repro.models``; dense family)."""
