"""The benchmark's own tests (CPU; the card cases are marked ``cuda``)."""
