"""The hand-written kernels (K1 ``pairwise``, K2 ``raymarch``, K3
``laser_fused``, SA-CADRL's value net ``cadrl_value``, DRL-Long's
convolutions ``drl_long_conv``, SA-CADRL's lookahead ``cadrl_lookahead``,
SARL's value net ``sarl_value``) with their plain versions, and ORCA.  Each
kernel module declares its C entries as ``build.Kernel``s, which count their
launches on the card (never a plain version's calls on the CPU) under the
name of their ``csrc/`` source."""

from gym_collision_avoidance_torch.ops.build import launch_counts, zero_launch_counts

__all__ = ["launch_counts", "zero_launch_counts"]
