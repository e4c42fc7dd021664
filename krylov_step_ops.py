"""Count the torch ops that each Krylov builder of ops/krylov.py dispatches
a step, on the CPU (view ops left out; the banded matvec is its plain
twin there, about eight ops). The step count is the difference between an
11-step and a 6-step call, over 5.

    python3 krylov_step_ops.py [TREE]

TREE: the root of a tree of this repository to count (default: the tree
this script is in), so two trees compare from one place.
"""

import collections
import os
import sys

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1
                else os.path.dirname(os.path.abspath(__file__)))

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import exponentialutilities_jl_torch as et                  # noqa: E402

VIEWS = {"view", "reshape", "_reshape_alias", "select", "slice", "unsqueeze",
         "expand", "t", "alias", "detach", "_unsafe_view", "squeeze",
         "as_strided", "real", "transpose", "permute", "lift_fresh"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def main():
    n = 500
    op = et.advection_diffusion_1d(n, peclet=10.0, device="cpu")
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    rec = et.lanczos_coeffs(op, b, 12)
    c = torch.linspace(1, 0.1, 12, dtype=torch.float64)
    Hc = et.arnoldi_coeffs(op, b, 12, 2)[0]
    calls = {
        "arnoldi iop=0": lambda m: et.arnoldi(op, b, m),
        "arnoldi iop=2": lambda m: et.arnoldi(op, b, m, iop=2),
        "lanczos_coeffs": lambda m: et.lanczos_coeffs(op, b, m),
        "lanczos_replay": lambda m: et.lanczos_replay(op, b, c[:m], rec[0],
                                                      rec[1], m),
        "arnoldi_coeffs": lambda m: et.arnoldi_coeffs(op, b, m, 2),
        "arnoldi_replay": lambda m: et.arnoldi_replay(op, b, c[:m], Hc, m,
                                                      2),
    }
    for name, f in calls.items():
        tot = {}
        for m in (6, 11):
            with Count() as cm:
                f(m)
            tot[m] = sum(cm.ops.values())
        print(f"{name}: {(tot[11] - tot[6]) / 5:.1f} ops a step", flush=True)


if __name__ == "__main__":
    main()
