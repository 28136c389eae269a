"""What every example shares: the ``--device`` and ``--no-plots`` flags."""

from __future__ import annotations

import argparse

import torch


def parser(description=None) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; without "
                    "one the example raises)")
    ap.add_argument("--no-plots", action="store_true",
                    help="write no figures (the card's machine has no "
                    "matplotlib)")
    return ap


def generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded ``seed``: where the JAX package
    splits ``PRNGKey(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)
