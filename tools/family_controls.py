#!/usr/bin/env python3
"""The bf16 controls that ``chip_smoke.py``'s phase 6f holds its training
families to, measured again.

    python3 tools/family_controls.py

On one GPU, for each family of phase 6f (``FAMILY_TRAIN``) at the depth
its explicit sync modes train, in bf16 from the same seeded weights and
phase 6's 3 steps of 8 x 512 tokens:

* ``grad_allreduce``: one pass over the global batch;
* the control, ``grad_allreduce`` with ``num_microbatches`` = 4: the ranks'
  own passes of 2 sequences, their gradients' mean taken in f32, no sync.

It prints the control's distance from ``grad_allreduce`` (last loss; grad
norms relative, the largest over the steps), which is what splitting the
batch into the ranks' passes costs in bf16, beside the value that
``FAMILY_BF16_CONTROL`` holds, and exits non-zero where they differ. The
readings repeat to every digit on one card; a change to the model's
arithmetic moves them, and the table is then updated from this output.
Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("family_controls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    sys.path.insert(0, cs.SRC)
    from repro_torch.configs import get_config

    cs.log(f"card: {cs.card()}")
    differ = []
    for _path, arch, layers, _labels, sync_layers in cs.FAMILY_TRAIN:
        depth = sync_layers if sync_layers is not None else layers
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        base = cs._family_run(torch, arch, cfg, "grad_allreduce")
        ctl = cs._family_run(torch, arch, cfg, "grad_allreduce_split", "control ")
        got, want = cs._deviation(ctl, base), cs.FAMILY_BF16_CONTROL[arch]
        cs.log(f"control {arch} ({cfg.num_layers} layers) against grad_allreduce: last loss "
               f"{got[0]!r}, grad norms {got[1]!r} relative at most; FAMILY_BF16_CONTROL "
               f"{want[0]!r}, {want[1]!r}")
        if tuple(got) != tuple(want):
            differ.append(arch)
    if differ:
        cs.log(f"family_controls: the readings of {differ} differ from FAMILY_BF16_CONTROL")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
