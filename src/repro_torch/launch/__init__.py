"""Launchers (port of ``repro.launch``; analytic training)."""
