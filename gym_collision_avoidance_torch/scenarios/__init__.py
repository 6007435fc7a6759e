from gym_collision_avoidance_torch.scenarios.presets import (
    Scenario,
    circle_scenario,
    two_agents_swap,
)

__all__ = ["Scenario", "circle_scenario", "two_agents_swap"]
