"""The `examples/` twins (`examples/port_*.py`) against the reference's
scripts, on the CPU: each pair loaded by path, run on the same arguments,
their captured standard output compared line for line.

  * quickstart and inspect_run whole (the reference's Perfetto trace
    pointed at `tmp_path` through its module's `__file__`, the twin's
    through `out_dir`: the same path printed, the same document written);
  * fleet_topology's analytical tables (`main` with its six measured
    sections left out), then each section on its own: the three
    simulator cross-checks at 200 requests and the SLO-constrained sizing
    at 1000, as `--sim-requests 200` runs them, the declarative IR and
    search at 200 requests with the search's budget cut from the script's
    12 evaluations to SEARCH_BUDGET on both sides, and the diurnal day
    compressed into 20 s;
  * the two card wrappers (`port_serve_demo.py`, `port_train_demo.py`)
    build the launcher's command line from the reference's defaults and
    run on the host under `--device cpu`.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

FLEET_SECTIONS = {   # fleet_topology's measured sections and their calls
    "simulated_crosscheck": dict(n_requests=200),
    "disaggregated_serving": dict(n_requests=200),
    "model_heterogeneous_serving": dict(n_requests=200),
    "slo_constrained_sizing": dict(n_requests=1000),
    "declarative_topology_ir": dict(n_requests=200),
    "diurnal_autoscaling": dict(day_s=20.0),
}
SEARCH_BUDGET = 4    # declarative_topology_ir's evaluations (the script's 12)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys, fn, *args, **kwargs):
    capsys.readouterr()
    fn(*args, **kwargs)
    return capsys.readouterr().out.splitlines()


def _assert_same(ref, port):
    assert len(ref) == len(port) and ref, (len(ref), len(port))
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"line {i}:\n  reference {a!r}\n  port      {b!r}"


def test_quickstart(capsys):
    _assert_same(_lines(capsys, _load("quickstart").main),
                 _lines(capsys, _load("port_quickstart").main))


def test_inspect_run(capsys, tmp_path):
    ref = _load("inspect_run")
    ref.__file__ = str(tmp_path / "inspect_run.py")
    want = _lines(capsys, ref.main)
    doc = json.loads((tmp_path / "fleet_trace.json").read_text())
    (tmp_path / "fleet_trace.json").unlink()
    got = _lines(capsys, _load("port_inspect_run").main, out_dir=tmp_path)
    _assert_same(want, got)
    assert json.loads((tmp_path / "fleet_trace.json").read_text()) == doc
    assert not (EXAMPLES / "fleet_trace.json").exists()


def test_fleet_topology_tables(capsys, monkeypatch):
    """`main`'s analytical tables (Table 3, the gain decomposition,
    gamma*, semantic vs context routing), its measured sections left out
    (they are compared one by one below)."""
    out = []
    for name in ("fleet_topology", "port_fleet_topology"):
        mod = _load(name)
        for section in FLEET_SECTIONS:
            monkeypatch.setattr(mod, section, lambda **kw: None)
        out.append(_lines(capsys, mod.main, sim_requests=200))
    _assert_same(*out)


@pytest.mark.parametrize("section", list(FLEET_SECTIONS))
def test_fleet_topology_section(capsys, monkeypatch, section):
    kw = FLEET_SECTIONS[section]
    import repro.core
    import repro_torch.core
    for core in (repro.core, repro_torch.core):
        real = core.optimize_topology
        monkeypatch.setattr(core, "optimize_topology",
                            lambda *a, _real=real, **k: _real(
                                *a, **dict(k, budget=SEARCH_BUDGET)))
    _assert_same(
        _lines(capsys, getattr(_load("fleet_topology"), section), **kw),
        _lines(capsys, getattr(_load("port_fleet_topology"), section), **kw))


@pytest.mark.parametrize("name, args, last", [
    ("port_serve_demo", ["--requests", "4", "--policies", "homo"],
     "homo"),
    ("port_train_demo", ["--preset", "smoke", "--steps", "2"],
     "final loss")])
def test_card_wrappers_run_on_the_host(name, args, last):
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}.py"), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert last in out.stdout, out.stdout
