"""Data parallelism over the env axis (port of
:mod:`gym_collision_avoidance_tpu.parallel`): a 1-D ``("env",)`` mesh of
``torch.distributed`` ranks, one device each, every rank stepping its own
contiguous slice of the env batch."""

from gym_collision_avoidance_torch.parallel.mesh import (
    EnvMesh,
    make_batched_rollout,
    make_batched_step,
    make_mesh,
    shard_env_batch,
    stack_states,
)

__all__ = ["EnvMesh", "make_mesh", "shard_env_batch", "stack_states", "make_batched_step",
           "make_batched_rollout"]
