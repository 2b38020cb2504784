"""The AFL client/coordinator protocol (port of ``repro.fl``)."""
