"""Device profiles on the card, the counterparts of the repo's
``scripts/profile_stages.py``, ``profile_forward.py`` and
``profile_cmu_ops.py``: ``tfpose-torch-profile {stages,forward,ops}``,
and ``spans``, the card's idle time by the program's spans. Each
submodule's ``main(argv)`` takes its own flags."""

from __future__ import annotations

import importlib
import sys

COMMANDS = ("stages", "forward", "ops", "spans")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit("usage: tfpose-torch-profile "
                         f"{{{','.join(COMMANDS)}}} [flags]  (got {argv[:1]})")
    module = importlib.import_module(f"tfpose_tpu_torch.profiles.{argv[0]}")
    return module.main(argv[1:])
