"""The sufficient-statistics engine (port of ``repro.core``)."""
