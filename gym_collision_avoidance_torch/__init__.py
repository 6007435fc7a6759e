"""PyTorch/CUDA port of ``gym_collision_avoidance_tpu``.

A second package beside the JAX one, with the same module names.  The env
step is plain PyTorch over ``[E, A, ...]`` batches; the pairwise collision
kernel (K1) is hand-written CUDA for Hopper (``csrc/pairwise.cu``), built
with ``nvcc`` at first use.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.  This package imports neither jax nor the
JAX package.
"""

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.state import EnvState, init_state
from gym_collision_avoidance_torch.env.step import env_reset, env_step

__version__ = "0.1.0"


def _register_gym_id():
    """Register ``CollisionAvoidanceTorch-v0`` with gymnasium at import, if
    gymnasium imports (the reference registers its id on package import,
    gym_collision_avoidance/__init__.py:2-9).  The JAX package owns
    ``CollisionAvoidance-v0`` and ``CollisionAvoidanceTpu-v0``.  The entry
    point is a string, so gymnasium imports the env class at ``make``."""
    try:
        from gymnasium.envs.registration import register, registry
    except ImportError:
        return
    if "CollisionAvoidanceTorch-v0" not in registry:
        register(id="CollisionAvoidanceTorch-v0",
                 entry_point="gym_collision_avoidance_torch.env.gymapi:CollisionAvoidanceEnv",
                 disable_env_checker=True)


_register_gym_id()

__all__ = ["EnvConfig", "EnvState", "init_state", "env_step", "env_reset"]
