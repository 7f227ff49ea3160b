"""One module per kind of cell, named by a traffic mix's ``driver``: its
``setup(ctx)`` returns a run with ``window(seconds, trace)``,
``release()``, ``check()`` and ``control(kind)``."""
