"""Shared setup of the port's example twins: puts the repo root on sys.path
and reads --device (default cuda, the card; --device cpu runs the port's
plain PyTorch versions instead of its kernels)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

_parser = argparse.ArgumentParser(add_help=False)
_parser.add_argument("--device", default="cuda")
DEVICE = _parser.parse_known_args()[0].device
