"""Modules seen in f64, for the f64 tests of the port.

Both packages pin norms, rope, attention's products, the xLSTM gates and
states and the loss's log-softmax to f32. Seen through ``F64``, a module
reads ``float32`` as ``float64``, so a model runs in f64 throughout with
neither package changed.
"""


class F64:
    """``mod`` with its ``float32`` read as ``float64``."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, "float64" if name == "float32" else name)


def read_f64(monkeypatch, pairs) -> None:
    """Set each ``(module, name)`` of ``pairs`` to ``F64`` of itself for the
    test (``monkeypatch``)."""
    for mod, name in pairs:
        monkeypatch.setattr(mod, name, F64(getattr(mod, name)))
