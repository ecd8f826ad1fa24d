"""End-to-end training driver: a ~100M-parameter-class Inhibitor LM.

Port of ``examples/train_inhibitor_lm.py`` as a launch entry, with its
flags.  Trains smollm-135m@inhibitor (the reduced config unless
``--full``) for a few hundred steps on the deterministic synthetic LM
stream with checkpointing, fault supervision and auto-resume, through
:mod:`repro_torch.launch.train`:

    python -m repro_torch.launch.train_inhibitor_lm --steps 300
    python -m repro_torch.launch.train_inhibitor_lm --full   # 135M params

Interrupt it and re-run: it resumes from the last committed checkpoint
(tests/test_torch_checkpoint.py holds a resumed run to an uninterrupted
one).  Checkpoints go to ``build/train_inhibitor_lm`` in the checkout
unless ``--ckpt-dir`` names another directory; ``--device`` is the
launcher's (default ``cuda``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.launch import train as train_cli

DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
                    / "train_inhibitor_lm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="train the real 135M config")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cli = ["--arch", "smollm-135m", "--attention", "inhibitor",
           "--steps", str(args.steps), "--batch", "16", "--seq", "256",
           "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
           "--device", args.device]
    if args.full:
        cli.append("--full")
    return train_cli.main(cli)


if __name__ == "__main__":
    raise SystemExit(main())
