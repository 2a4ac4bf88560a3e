"""``scripts/trace_pipeline.py``: its reading of a Chrome trace (busy time
as the union of kernel intervals, each compute gap split into the part
before the host's launch call and the rest, kernels by kind, launch to
start) on a trace made by hand, and its whole control flow (the launcher,
the ranks' GPipe steps, the traced step, the hop alone, the sequential
stack on rank 0, ``summary.json``) on two gloo ranks on the CPU at its tiny
size."""
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location(
        "trace_pipeline", ROOT / "scripts" / "trace_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read_trace_splits_the_gaps(tmp_path):
    tp = _script()
    events = [
        _x("user_annotation", "pp_step", 0.0, 1000.0),
        _x("cpu_op", "aten::mm", 5.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0, 1),
        _x("kernel", "nvjet_tst_64x200", 20.0, 100.0, 1),
        # launched 80 us after the device went idle: 80 host-late, 10 not
        _x("cuda_runtime", "cudaLaunchKernel", 200.0, 5.0, 2),
        _x("kernel", "vectorized_elementwise_kernel", 210.0, 50.0, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 215.0, 5.0, 3),
        _x("kernel", "ncclDevKernel_SendRecv", 260.0, 300.0, 3),
        # launched before the device went idle: the whole gap a dependency
        _x("cuda_runtime", "cudaLaunchKernel", 230.0, 5.0, 4),
        _x("kernel", "mhsa_reg_kernel<64>", 600.0, 40.0, 4),
        _x("kernel", "outside_the_step", 2000.0, 10.0, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = tp._read_trace(str(path), "pp_step")
    assert r["step_ms"] == pytest.approx(1.0)
    assert r["kernels"] == 4
    assert r["busy_ms"] == pytest.approx(0.49)
    assert r["compute_busy_ms"] == pytest.approx(0.19)
    assert r["gap_host_ms"] == pytest.approx(0.08)
    assert r["gap_dependency_ms"] == pytest.approx(0.35)
    assert r["lead_ms"] == pytest.approx(0.02)
    assert r["tail_ms"] == pytest.approx(0.36)
    assert {k: v["count"] for k, v in r["by_kind"].items()} == {
        "gemm": 1, "other": 1, "nccl": 1, "attention": 1}
    assert r["launch_calls"] == 4
    assert r["launch_to_start_us"]["median"] == pytest.approx(10.0)
    assert r["host_us_a_launch"] == pytest.approx(250.0)
    assert r["top_ops"] == [["aten::mm", 1, pytest.approx(0.02)]]
    assert tp._read_trace(str(path), "another_step") == {}


def test_trace_pipeline_runs_on_cpu_ranks(tmp_path):
    tp = _script()
    out = tmp_path / "trace"
    rc = tp.main(["--device", "cpu", "--tiny", "--stages", "2",
                  "--microbatches", "2", "--steps", "1", "--output",
                  str(out)])
    assert rc == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["card"] == "cpu" and len(summary["ranks"]) == 2
    for r in summary["ranks"]:
        assert r["backend"] == "gloo" and r["wall_median_ms"] > 0
        assert r["traced"]["step_ms"] > 0 and r["hop_alone_ms"] > 0
        assert len(r["traced"]["top_ops"]) == tp.TOP
    assert summary["ranks"][0]["seq_wall_median_ms"] > 0
    assert (out / "rank1_trace.json.gz").exists()
