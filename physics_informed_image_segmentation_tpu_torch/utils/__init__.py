"""Utilities: device selection, kernel builds, weight import, plots."""
