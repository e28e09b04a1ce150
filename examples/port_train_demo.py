"""Training example on the PyTorch port, the twin of
examples/train_demo.py: train a small decoder on the synthetic Markov
corpus on the card and watch the loss drop.  Arguments are passed on to
the launcher after the reference's defaults, which they override one by
one (`--device cpu` runs it on the host; --preset 100m --steps 300 for
the full-scale run).

  PYTHONPATH=src python examples/port_train_demo.py [--device cpu]
"""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEFAULTS = ["--preset", "10m", "--steps", "60", "--batch", "4", "--seq", "64"]

if __name__ == "__main__":
    path = os.pathsep.join(filter(None, [str(ROOT / "src"),
                                         os.environ.get("PYTHONPATH")]))
    sys.exit(subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         *DEFAULTS, *sys.argv[1:]],
        env={**os.environ, "PYTHONPATH": path}))
