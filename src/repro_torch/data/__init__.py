"""Synthetic datasets (copied from ``repro.data``)."""
