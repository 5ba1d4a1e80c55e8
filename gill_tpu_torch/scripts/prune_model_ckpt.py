"""Prune a training run's checkpoint into the small deployment checkpoint
(counterpart of scripts/prune_model_ckpt.py; reference
scripts/prune_model_ckpt.py). Host-only.

    python -m gill_tpu_torch.scripts.prune_model_ckpt runs/gill_exp

Reads the run's `ckpt_best/` (else `ckpt/`) as utils/ckpt.py
`load_checkpoint` reads it and writes `<run>/pretrained_ckpt.npz` with the
adapters only (no optimizer state), under gill_tpu's flat `a//b` names.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from gill_tpu_torch.utils.ckpt import _flatten, load_checkpoint


def prune(model_dir: str) -> str:
    """Writes and returns `<model_dir>/pretrained_ckpt.npz`."""
    src = os.path.join(model_dir, "ckpt_best")
    if not os.path.exists(os.path.join(src, "state.npz")):
        src = os.path.join(model_dir, "ckpt")
    tree, meta = load_checkpoint(src)
    out_path = os.path.join(model_dir, "pretrained_ckpt.npz")
    np.savez(out_path, **_flatten(tree["adapters"]))
    size_mb = os.path.getsize(out_path) / 1e6
    print(f"Wrote {out_path} ({size_mb:.1f} MB, step {meta.get('step')})")
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m gill_tpu_torch.scripts."
                         "prune_model_ckpt RUN_DIR")
    return prune(argv[0])


if __name__ == "__main__":
    main()
