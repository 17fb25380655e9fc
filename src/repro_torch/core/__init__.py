"""Core: schedule IR, cost models, tuner, pytree bucketing (no torch needed
except by :mod:`.bucketing`)."""
