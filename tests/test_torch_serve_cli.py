"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU at the reduced qwen3 config: the trace mode under SLO classes
(fixed count and online), the streamed and the wave fixed modes, the
online Router and the adaptive pool each print what JAX's launcher
prints; the reduced gemma and 8B configs serve the fixed mode; without
a card the default ``--device cuda`` raises."""
from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

CPU = ["--device", "cpu", "--reduced"]
REPORT = re.compile(r"^trace (\S+) \(seed (\d+), time_scale ([\d.]+)\): "
                    r"(\d+)/(\d+) done, (\d+) shed, (\d+) failed in "
                    r"([\d.]+)s$", re.M)


def _run(capsys, *args) -> str:
    serve.main([*CPU, *args])
    return capsys.readouterr().out


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_trace_mode_fixed_count_prints_the_report_and_classes(capsys):
    out = _run(capsys, "--trace", "poisson-light", "--time-scale", "30",
               "--priority-classes", "interactive:0.5,batch:8.0",
               "--tenant-quota", "8", "--containers", "2",
               "--cache", "paged", "--prefix-cache")
    m = REPORT.search(out)
    assert m, out
    name, seed, scale, done, total, shed, failed, _ = m.groups()
    assert (name, seed, float(scale)) == ("poisson-light", "0", 30.0)
    assert int(done) + int(shed) + int(failed) == int(total) > 0
    assert re.search(r"^goodput [\d.]+ rps  ttfc p95 [\d.]+s  energy/done "
                     r"[\d.]+J  counts \[\] -> n=2$", out, re.M), out
    classes = re.findall(r"^  \[(\w+)\] done \d+ shed \d+ failed \d+ ttfc "
                         r"p95 [\d.]+s", out, re.M)
    assert set(classes) <= {"interactive", "batch"} and classes


def test_trace_mode_online_prints_windows_with_per_class_lines(capsys):
    out = _run(capsys, "--trace", "poisson-light", "--time-scale", "30",
               "--slo-ttfc-p95", "2.0", "--units", "2", "--requests", "4",
               "--max-queue", "16")
    assert REPORT.search(out), out
    assert re.search(r"^window 0: n=\d ", out, re.M), out
    # one SLO class named "default" from --slo-ttfc-p95
    assert re.search(r"^    \[default\] done \d+ shed \d+ failed \d+ ttfc "
                     r"p95 [\d.]+s target 2.000s (MET|VIOLATED)$", out,
                     re.M), out
    assert re.search(r"counts \[[\d, ]+\] -> n=[12]$", out, re.M), out


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("stream", [True, False])
def test_fixed_mode_serves_and_prints_the_wave(capsys, stream):
    out = _run(capsys, "--containers", "2", "--requests", "4",
               "--max-new", "3", *([] if stream else ["--no-stream"]),
               "--print-chunks")
    mode = "concurrent+stream" if stream else "concurrent"
    assert re.search(rf"^n=2 \({re.escape(mode)}\): 4 requests, 12 tokens "
                     r"in ", out, re.M), out
    assert len(re.findall(r"^  container \d: \d reqs wall", out, re.M)) == 2
    if stream:
        assert "streamed 4 requests: ttfc p50" in out
        assert len(re.findall(r"^  rid \d \[container \d\] ttfc", out,
                              re.M)) == 4


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("stream", [True, False])
def test_online_mode_prints_windows_and_the_choice(capsys, stream):
    out = _run(capsys, "--units", "2", "--requests", "3", "--waves", "3",
               "--max-new", "3", *([] if stream else ["--no-stream"]))
    line = r"^window \d: n=\d " if stream else r"^wave \d: n=\d wall "
    assert len(re.findall(line, out, re.M)) == 3, out
    assert "feasible counts: [1, 2]" in out
    assert re.search(r"^converged choice: n=[12]$", out, re.M)
    assert "scheduler summary:" in out


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen3-8b", "llama3.1-8b"])
def test_new_archs_serve_reduced_on_the_cpu(capsys, arch):
    """``--arch gemma3-27b --reduced --device cpu`` (and the 8B configs)
    serves the fixed mode over paged engines, gemma's local rings beside
    its paged global layer."""
    out = _run(capsys, "--arch", arch, "--containers", "2", "--requests",
               "4", "--max-new", "3", "--cache", "paged")
    assert re.search(r"^n=2 \(concurrent\+stream\): 4 requests, 12 "
                     r"tokens in ", out, re.M), out
    assert out.rstrip().splitlines()[-1].startswith("kernel launches: ")


def test_no_submesh_and_no_card_means_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--containers", "1", "--requests", "1"])
    with pytest.raises(SystemExit):
        serve.main([*CPU, "--submesh"])
