"""On-device PPO training (port of :mod:`gym_collision_avoidance_tpu.train`)."""

from gym_collision_avoidance_torch.train.ppo import (
    PPOConfig,
    PPOTrainer,
    actor_critic,
    compute_gae,
    init_actor_critic,
    make_ppo,
    make_sharded_ppo,
)

__all__ = ["PPOConfig", "PPOTrainer", "actor_critic", "compute_gae", "init_actor_critic",
           "make_ppo", "make_sharded_ppo"]
