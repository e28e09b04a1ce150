"""The port's table tools vs the reference's benchmark scripts.

`tools/port_paper_tables.py`: every suite's rows and `derived` string equal
those of the reference script's function that `benchmarks/run.py` runs
under the same name (each script loaded by path, as
tests/core/test_bench_schema.py loads the benches).

`tools/port_trace_report.py`: its `gate` keys on the reconciliation as the
reference report's does (the mirror of test_bench_schema's
`test_trace_report_gate_keys_on_reconciliation`), and a traced Table F
cell's row and timeline equal the reference report's on the same
arguments, at a short day.
"""
import importlib.util
import sys
from pathlib import Path

import pytest

from test_torch_fleet_core import _plain

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import port_paper_tables as PPT  # noqa: E402
import port_trace_report as PTR  # noqa: E402


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# benchmarks/run.py's suite names -> (script, function)
REFERENCE = {
    "table1_context_law": ("table1_context_law", "run"),
    "table2_model_archs": ("table2_model_archs", "run"),
    "table3_fleet_topology": ("table3_fleet_topology", "run"),
    "table4_semantic_routing": ("table4_semantic_routing", "run"),
    "table5_gpu_generations": ("table5_gpu_generations", "run"),
    "table6_archetypes": ("table6_archetypes", "run"),
    "table7_power_params": ("table7_power_params", "run"),
    "quantization_sweep": ("extra_sweeps", "quantization"),
    "moe_dispatch_sensitivity": ("extra_sweeps", "moe_dispatch"),
    "per_arch_one_over_w": ("extra_sweeps", "per_arch_law"),
    "beyond_paper": ("beyond_paper", "run"),
}


def test_suites_are_the_reference_harness_names():
    assert list(PPT.SUITES) == list(REFERENCE)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_suite_equals_reference_script(name):
    fname, fn = REFERENCE[name]
    ref_rows, ref_derived = getattr(_load(fname), fn)()
    rows, derived = PPT.SUITES[name]()
    assert rows, name
    assert _plain(rows) == _plain(ref_rows)
    assert derived == ref_derived


def test_table1_worst_cell_delta():
    """Table 1's headline: every cell within 0.4% of the paper's tok/W."""
    rows, derived = PPT.table1_context_law()
    assert derived == "worst_cell_delta=0.4%"
    assert max(abs(r["delta_pct"]) for r in rows) <= 0.4


def test_main_writes_every_suite(tmp_path, capsys):
    assert PPT.main(["--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == list(PPT.SUITES)
    assert sorted(p.stem for p in tmp_path.glob("*.json")) \
        == sorted(PPT.SUITES)


def test_main_exits_1_when_a_suite_raises(tmp_path, monkeypatch, capsys):
    def broken():
        raise RuntimeError("planted")

    monkeypatch.setitem(PPT.SUITES, "table7_power_params", broken)
    assert PPT.main(["--only", "table7", "--out", str(tmp_path)]) == 1
    assert "table7_power_params,ERROR,RuntimeError: planted" \
        in capsys.readouterr().out


# --- tools/port_trace_report.py ----------------------------------------------

def _trace_rows(err=0.0):
    return [dict(generation="H100", topology="fleetopt",
                 provisioning="autoscaled", reconcile_max_rel_err=err)]


def test_trace_report_gate_keys_on_reconciliation():
    ref = _load("fleet_trace_report")
    assert PTR.gate(_trace_rows(1e-9)) == [] == ref.gate(_trace_rows(1e-9))
    fails = PTR.gate(_trace_rows(5e-3))
    assert len(fails) == 1 and "H100/fleetopt/autoscaled" in fails[0]
    assert fails == ref.gate(_trace_rows(5e-3))


@pytest.mark.parametrize("kind,provisioning", [
    ("fleetopt", "autoscaled"), ("homo", "static")])
def test_trace_report_cell_equals_reference(kind, provisioning):
    """One traced Table F cell at a short day (peak 40 req/s, a 30 s day,
    300 sizing requests): the row, ramp lag included, and the timeline
    equal the reference report's."""
    ref = _load("fleet_trace_report")
    kw = dict(peak_rate=40.0, day_s=30.0, slo_requests=300, seed=0)
    from repro.core.profiles import H100_LLAMA70B as REF_H100
    from repro_torch.core.profiles import H100_LLAMA70B
    r_row, r_tl, _, _ = ref.run_cell("H100", REF_H100, kind, provisioning,
                                     sized_cache={}, **kw)
    row, tl, rec, _ = PTR.run_cell("H100", H100_LLAMA70B, kind, provisioning,
                                   sized_cache={}, **kw)
    assert _plain(row) == _plain(r_row)
    assert _plain(tl.to_json()) == _plain(r_tl.to_json())
    assert PTR.gate([row]) == [] and row["n_events"] == len(rec.events)
