"""Deterministic token sources and batches."""
