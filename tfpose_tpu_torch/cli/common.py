"""Flags and set-up shared by the port's CLIs."""

from __future__ import annotations

import argparse
import logging
from typing import Tuple

from tfpose_tpu_torch.models import model_wh


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs the kernels' plain versions)")


def network_size(resize: str) -> Tuple[int, int]:
    """``--resize`` as (w, h); '0x0' means 432x368, as in the scripts."""
    w, h = model_wh(resize)
    if w == 0 or h == 0:
        w, h = 432, 368
    return w, h
