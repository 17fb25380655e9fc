"""Optimizers and learning-rate schedules."""
