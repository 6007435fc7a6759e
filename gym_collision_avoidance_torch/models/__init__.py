"""Policy networks of the port (port of :mod:`gym_collision_avoidance_tpu.models`)."""
