"""End-to-end serving example on the PyTorch port, the twin of
examples/serve_demo.py: a real reduced model served with batched requests
through context-length-routed pools on the card, energy metered per
decode iteration, comparing homogeneous vs FleetOpt routing.  Arguments
are passed on to the launcher after the defaults (`--device cpu` runs it
on the host).

  PYTHONPATH=src python examples/port_serve_demo.py [--device cpu]
"""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    path = os.pathsep.join(filter(None, [str(ROOT / "src"),
                                         os.environ.get("PYTHONPATH")]))
    sys.exit(subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
         "--requests", "24", *sys.argv[1:]],
        env={**os.environ, "PYTHONPATH": path}))
