"""What the examples share: the ``--device`` option and a printer that
keeps the lines it printed."""

from __future__ import annotations

import argparse

import torch

from ..core.device import default_device


class Printer:
    """``print`` that also keeps each line, for ``main`` to return."""

    def __init__(self):
        self.lines = []

    def __call__(self, *args) -> None:
        line = " ".join(str(a) for a in args)
        print(line, flush=True)
        self.lines.append(line)


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def device_of(args) -> torch.device:
    """The example's device: ``--device``, else the card (raises without
    one)."""
    return default_device(args.device)
