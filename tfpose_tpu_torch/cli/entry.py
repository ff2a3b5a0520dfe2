"""Console-script entry points of the port (``pyproject.toml``:
``tfpose-torch-run``, ``-video``, ``-webcam``, ``-eval``, ``-train``,
``-convert``, ``-dataworker``, ``-parity-sweep``, ``-broadcaster``,
``-visualization``, ``-sweep-backbones``, ``-profile``), the
counterparts of ``tfpose_tpu/cli/entry.py`` and of the repo's
``scripts/broadcaster.py``, ``visualization.py``, ``sweep_backbones.py``
and ``profile_*.py``."""

from __future__ import annotations


def run_main():
    from tfpose_tpu_torch.cli.run import main
    main()


def video_main():
    from tfpose_tpu_torch.cli.run_video import main
    main()


def webcam_main():
    from tfpose_tpu_torch.cli.run_webcam import main
    main()


def eval_main():
    from tfpose_tpu_torch.cli.eval import main
    main()


def train_main():
    from tfpose_tpu_torch.cli.train import main
    main()


def convert_main():
    from tfpose_tpu_torch.cli.convert import main
    main()


def dataworker_main():
    from tfpose_tpu_torch.cli.dataworker import main
    main()


def parity_sweep_main():
    from tfpose_tpu_torch.evaluation.parity_sweep import main
    main()


def broadcaster_main():
    from tfpose_tpu_torch.cli.broadcaster import main
    main()


def visualization_main():
    from tfpose_tpu_torch.cli.visualization import main
    main()


def sweep_backbones_main():
    from tfpose_tpu_torch.evaluation.backbone_sweep import main
    main()


def profile_main():
    from tfpose_tpu_torch.profiles import main
    main()
