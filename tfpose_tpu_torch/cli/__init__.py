"""Command-line entry points of the port: counterparts of the repo's
``run.py``, ``run_video.py``, ``run_webcam.py`` and ``eval.py``, each a
``main(argv)`` with the JAX script's flags plus ``--device``. File,
video and window I/O needs cv2, imported inside the functions that do
it."""
