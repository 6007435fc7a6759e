"""Write SARL's seeded checkpoint, ``models/weights/sarl_seeded.npz``: the
value net at its published widths with PyTorch's default ``nn.Linear`` init
drawn from ``models.sarl.SEED``, in float32 under CrowdNav's state-dict
names.  The trained CrowdNav checkpoint is not in this repository; this
file stands in for it at the same shapes.  Runs on the CPU in a second::

    python3 scripts/make_sarl_weights.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gym_collision_avoidance_torch.models import sarl  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=sarl.CHECKPOINTS["seeded"])
    args = ap.parse_args(argv)
    net = sarl.init_params(device="cpu")
    arrays = {k: v.numpy().astype(np.float32) for k, v in net.state_dict().items()}
    np.savez(args.out, **arrays)
    print(f"{args.out}: {sum(a.size for a in arrays.values())} parameters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
