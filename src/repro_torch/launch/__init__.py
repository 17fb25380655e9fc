"""Mesh construction (the emulated data axis on one card)."""
