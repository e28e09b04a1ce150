"""Import and device hygiene of the port.

The port, `chip_smoke.py`, the port's tools (`tools/port_fleet_bench.py`,
`tools/port_paper_tables.py`, `tools/port_trace_report.py`,
`tools/port_roofline_report.py`, `tools/port_opt_vs_baseline.py`) and the
`examples/port_*.py` twins import neither jax nor the reference package
`repro`; importing them leaves jax unloaded; the port's entry points
refuse to run on CUDA when there is none instead of falling back to the
CPU; and its kernel modules import where no CUDA toolkit is installed.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + [ROOT / "tools" / f"{name}.py" for name in (
        "port_fleet_bench", "port_paper_tables", "port_trace_report",
        "port_roofline_report", "port_opt_vs_baseline",
        "dryrun_peak_tensor", "compare_prefill")] \
    + sorted((ROOT / "examples").glob("port_*.py"))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.kernels.ops, repro_torch.serving.models, "
            "repro_torch.core.fleet, repro_torch.core.routing, "
            "repro_torch.core.topospec, repro_torch.core.timeline, "
            "repro_torch.core.autoscale, repro_torch.core.disagg, "
            "repro_torch.core.multipool, repro_torch.core.slo, "
            "repro_torch.serving.telemetry, repro_torch.serving.energy, "
            "repro_torch.serving.engine, repro_torch.serving.autoscale, "
            "repro_torch.serving.soa, repro_torch.serving.fleetsim, "
            "repro_torch.serving.graph_engine, repro_torch.core.topo_search, "
            "repro_torch.core.analyzer, repro_torch.core.adaptive, "
            "repro_torch.training, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.launch.dryrun; "
            f"sys.path.insert(0, {str(ROOT / 'tools')!r}); "
            "import port_fleet_bench, port_paper_tables, port_trace_report, "
            "port_roofline_report, port_opt_vs_baseline; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.training import train_loop, AdamW
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--preset", "smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(get_config("yi-6b").reduced(), steps=1, batch_iter=None,
                   opt=AdamW())
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(get_config("yi-6b").reduced(), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()


def test_kernel_module_imports_without_nvcc():
    code = ("import repro_torch.kernels.flash_decode as fd, "
            "repro_torch.kernels.flash_decode_int8 as fd8, "
            "repro_torch.kernels.mamba_scan as ms, "
            "repro_torch.kernels.wkv6 as wk; "
            "print(fd.flash_decode.launches"
            " + fd8.flash_decode_int8.launches + ms.mamba_scan.launches"
            " + wk.wkv6.launches)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "0"
