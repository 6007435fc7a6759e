"""Utilities (port of :mod:`gym_collision_avoidance_tpu.utils`)."""
