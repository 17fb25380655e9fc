"""Mesh metadata (axis roles) shared by the planner and the engine."""
