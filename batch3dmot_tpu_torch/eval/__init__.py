"""Tracking evaluation (native AMOTA)."""
