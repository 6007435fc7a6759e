"""The hand-written kernels (K1 ``pairwise``, K2 ``raymarch``, K3
``laser_fused``, SA-CADRL's value net ``cadrl_value``) with their plain
versions, and ORCA.  Each kernel module's
``LAUNCHES`` counts its launches on the card (never its plain version's
calls on the CPU)."""

import importlib

KERNEL_MODULES = ("pairwise", "raymarch", "laser_fused", "cadrl_value")


def launch_counts() -> dict:
    """``{module: LAUNCHES}`` of the kernel modules."""
    return {name: importlib.import_module(f"{__name__}.{name}").LAUNCHES
            for name in KERNEL_MODULES}


def zero_launch_counts() -> None:
    """Set every kernel module's ``LAUNCHES`` to 0."""
    for name in KERNEL_MODULES:
        importlib.import_module(f"{__name__}.{name}").LAUNCHES = 0
