"""The port's static-analysis suite (repro_torch.analysis), on the cases of
tests/test_analysis.py for host-sync, concurrency, wire, the report and
the CLI: every analyzer runs clean on the port as it stands AND catches a
seeded violation in a copy of the port's own sources."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import ANALYZERS, run_analyzers  # noqa: E402
from repro_torch.analysis import concurrency, host_sync, wire  # noqa: E402
from repro_torch.analysis.report import (Finding, Report,  # noqa: E402
                                         apply_suppressions,
                                         line_suppressed)

REPO = pathlib.Path(__file__).resolve().parents[1]
SERVING = REPO / "src" / "repro_torch" / "serving"
ENGINE = (SERVING / "engine.py").read_text()
BACKEND = (SERVING / "backend.py").read_text()
CACHE = SERVING / "cache.py"

# the graph path's read-back, the stray sites' anchors
READ_BACK = '        out = self._buf["out"][:B * (n_tokens + 1)].cpu().numpy()\n'
FINISH = "        comp = Completion(s.rid, s.generated, s.prompt_len, " \
         "now - s.started,\n"


def _engine_copy(tmp_path, old: str, new: str) -> pathlib.Path:
    assert ENGINE.count(old) == 1, old
    path = tmp_path / "engine.py"
    path.write_text(ENGINE.replace(old, new))
    return path


def _codes(findings) -> list[str]:
    return [f.code for f in findings]


# ---------------------------------------------------------------------------
# report plumbing
# ---------------------------------------------------------------------------
def test_report_json_shape():
    rep = Report()
    rep.analyzers_run.append("wire")
    rep.extend([Finding("wire", "WIR001", "x/y", "msg")])
    data = json.loads(rep.to_json())
    assert data["schema"] == 1
    assert data["counts"] == {"errors": 1, "warnings": 0}
    assert data["findings"][0]["code"] == "WIR001"
    assert not rep.ok


def test_line_suppression_same_line_and_above():
    lines = ["a = 1", "x = sync()  # analysis: allow(host-sync)",
             "# analysis: allow(concurrency)", "y = 2"]
    assert line_suppressed(lines, 2, "host-sync")
    assert not line_suppressed(lines, 2, "concurrency")
    assert line_suppressed(lines, 4, "concurrency")
    assert not line_suppressed(lines, 1, "host-sync")


def test_code_suppression():
    fs = [Finding("wire", "WIR002", "a", "m"),
          Finding("wire", "WIR003", "b", "m")]
    assert _codes(apply_suppressions(fs, ["WIR002"])) == ["WIR003"]


def test_unknown_analyzer_rejected():
    with pytest.raises(KeyError):
        run_analyzers(["not-an-analyzer"])


def test_the_suite_is_the_three_the_port_lacked():
    assert set(ANALYZERS) == {"host-sync", "concurrency", "wire"}
    doc = sys.modules["repro_torch.analysis"].__doc__
    for where in ("_check_addresses", "ptxas_report.py", "captured"):
        assert where in doc


# ---------------------------------------------------------------------------
# host-sync auditor
# ---------------------------------------------------------------------------
def test_host_sync_clean():
    findings = host_sync.run()
    assert findings == [], "\n".join(map(str, findings))


def test_host_sync_catches_stray_item_reachable_from_step(tmp_path):
    ep = _engine_copy(tmp_path, FINISH,
                      '        n = self._buf["emitted"].item()\n' + FINISH)
    findings = host_sync.run(ep, CACHE)
    assert _codes(findings) == ["SYN001"]
    assert "_finish" in findings[0].message

    # the same sync under an allow marker passes
    ep = _engine_copy(tmp_path, FINISH,
                      '        n = self._buf["emitted"].item()  '
                      '# analysis: allow(host-sync)\n' + FINISH)
    assert host_sync.run(ep, CACHE) == []


def test_host_sync_catches_a_second_read_on_the_graph_path(tmp_path):
    """One D2H a path: the CPU branch and the card's branch each read
    once, so the method's two ``.cpu()`` sites pass; a second read on the
    card's path does not."""
    ep = _engine_copy(tmp_path, READ_BACK, READ_BACK
                      + '        extra = self._buf["emitted"].cpu()\n')
    findings = host_sync.run(ep, CACHE)
    assert _codes(findings) == ["SYN001"]
    assert "_run_chunk" in findings[0].message
    idx = host_sync._load(SERVING / "engine.py")["ServingEngine"]
    kinds = sorted(k for k, _ in idx.scans["_run_chunk"].sites.values())
    assert kinds == ["d2h", "d2h", "h2d", "h2d"]
    for by_kind in idx.path_counts("_run_chunk"):
        assert {k: len(v) for k, v in by_kind.items()} == {"d2h": 1,
                                                           "h2d": 1}


def test_host_sync_catches_an_extra_copy_in_and_a_sync(tmp_path):
    ep = _engine_copy(tmp_path, "        self.chunks += 1\n",
                      "        self.chunks += 1\n"
                      "        t = torch.tensor([1], device=self.device)\n")
    assert _codes(host_sync.run(ep, CACHE)) == ["SYN002"]
    ep = _engine_copy(tmp_path, "        self.steps += 1\n",
                      "        self.steps += 1\n"
                      "        torch.cuda.synchronize()\n")
    assert _codes(host_sync.run(ep, CACHE)) == ["SYN001"]
    # a read inside the replay loop runs once a step: many a path
    ep = _engine_copy(tmp_path, "            self._graph.replay()\n",
                      "            self._graph.replay()\n"
                      "            self._buf['col'].cpu()\n")
    assert "SYN001" in _codes(host_sync.run(ep, CACHE))


def test_host_sync_admission_copies_in_are_free_its_reads_are_not(
        tmp_path):
    idx = host_sync._load(SERVING / "engine.py")["ServingEngine"]
    assert [k for k, _ in idx.scans["_admit_batch"].sites.values()] \
        and {k for k, _ in idx.scans["_admit_batch"].sites.values()} \
        == {"h2d"}
    ep = _engine_copy(tmp_path, "        first = self._pick(logits)\n",
                      "        first = self._pick(logits)\n"
                      "        top = logits.max().item()\n")
    findings = host_sync.run(ep, CACHE)
    assert _codes(findings) == ["SYN001"]
    assert "_admit_batch" in findings[0].message


def test_host_sync_numpy_values_are_no_sites():
    """``block[i, :c].tolist()`` reads a numpy block (``_run_chunk`` is
    annotated to return host arrays) and ``new_key(..).numpy()`` a CPU
    tensor (its ``device`` defaults to "cpu"): neither is counted."""
    idx = host_sync._load(SERVING / "engine.py")["ServingEngine"]
    lines = ENGINE.splitlines()
    tolist = next(i + 1 for i, ln in enumerate(lines)
                  if "block[i, :c].tolist()" in ln)
    key = next(i + 1 for i, ln in enumerate(lines)
               if "self.config.seed, self._draw).numpy()" in ln)
    sites = {ln for m in idx.scans.values() for _, ln in m.sites.values()}
    assert tolist not in sites and key not in sites
    assert idx.scans["_decode_chunk"].sites == {}


def test_host_sync_tells_a_host_block_from_a_tensor(tmp_path):
    src = textwrap.dedent("""
        import numpy as np
        import torch
        class ServingEngine:
            def step(self):
                self._decode_chunk()
            def _decode_chunk(self):
                block, emitted = self._run_chunk()
                new = block[0, :2].tolist()
                return new, int(emitted[0])
            def _run_chunk(self) -> tuple[np.ndarray, np.ndarray]:
                return np.zeros((2, 2)), np.zeros(2)
    """)
    ep, cp = tmp_path / "engine.py", tmp_path / "cache.py"
    cp.write_text("class DenseCache:\n    pass\nclass PagedCache:\n"
                  "    pass\n")
    ep.write_text(src)
    assert host_sync.run(ep, cp) == []
    ep.write_text(src.replace("tuple[np.ndarray, np.ndarray]",
                              "tuple[torch.Tensor, torch.Tensor]"))
    assert sorted(_codes(host_sync.run(ep, cp))) == ["SYN001", "SYN001"]


def test_host_sync_follows_the_cache_backend(tmp_path):
    cache = CACHE.read_text()
    old = "    def free(self, row: int) -> None:\n"
    # the CacheBackend protocol's, DenseCache's and PagedCache's
    assert cache.count(old) == 3
    at = cache.index(old, cache.index("class DenseCache")) + len(old)
    cp = tmp_path / "cache.py"
    seed = "        seen = self.tree[0]['k'].sum().item()\n"
    cp.write_text(cache[:at] + seed + cache[at:])
    findings = host_sync.run(SERVING / "engine.py", cp)
    assert _codes(findings) == ["SYN001"]
    assert "DenseCache.free" in findings[0].message


# ---------------------------------------------------------------------------
# concurrency lint
# ---------------------------------------------------------------------------
def test_concurrency_clean():
    findings = concurrency.run()
    assert findings == [], "\n".join(map(str, findings))


def test_concurrency_sees_the_ports_thread_roots():
    import ast
    roots = {}
    for node in ast.parse(BACKEND).body:
        if isinstance(node, ast.ClassDef):
            audit = concurrency._ClassAudit(node, SERVING / "backend.py",
                                            BACKEND.splitlines())
            roots[node.name] = {(r.func, r.spawner) for r in audit.roots}
    assert ("run_one", "drain") in roots["ThreadBackend"]
    assert ("send", "_send_params") in roots["ProcessBackend"]


def test_concurrency_catches_a_cross_thread_write_in_the_backend(tmp_path):
    old = "                out[cid] = (comps, time.perf_counter() - t0,\n"
    assert BACKEND.count(old) == 1
    p = tmp_path / "backend.py"
    p.write_text(BACKEND.replace(
        old, "                self._alive[cid] = False\n" + old))
    findings = concurrency.run((p,))
    assert "CON001" in _codes(findings)
    assert any("ThreadBackend._alive" in f.message for f in findings)


def test_concurrency_catches_cross_thread_write(tmp_path):
    bad = textwrap.dedent("""
        import threading
        class Pool:
            def start(self):
                threading.Thread(target=self._pump, daemon=True).start()
            def _pump(self):
                self.alive = True
            def stop(self):
                self.alive = False
            def fan(self):
                for i in range(3):
                    t = threading.Thread(target=self._work)
                    t.start()
                    t.join()
            def _work(self):
                self.count += 1
    """)
    p = tmp_path / "bad.py"
    p.write_text(bad)
    assert sorted({f.code for f in concurrency.run((p,))}) \
        == ["CON001", "CON002"]


def test_concurrency_respects_lock_and_suppression(tmp_path):
    good = textwrap.dedent("""
        import threading
        class Pool:
            def start(self):
                threading.Thread(target=self._pump, daemon=True).start()
            def _pump(self):
                with self._lock:
                    self.alive = True
            def stop(self):
                with self._lock:
                    self.alive = False
            def mark(self):
                self.seen = True  # analysis: allow(concurrency)
            def bg(self):
                threading.Thread(target=self._set).start()
            def _set(self):
                self.seen = False  # analysis: allow(concurrency)
    """)
    p = tmp_path / "good.py"
    p.write_text(good)
    assert concurrency.run((p,)) == []


# ---------------------------------------------------------------------------
# wire: pre-affinity imports + pipe picklability
# ---------------------------------------------------------------------------
def test_wire_clean():
    findings = wire.run()
    assert findings == [], "\n".join(map(str, findings))
    assert wire.PRE_AFFINITY_MODULES == (
        "repro_torch.serving.child", "repro_torch.core.testbed",
        "repro_torch.serving.events", "repro_torch.serving.faults",
        "repro_torch.configs.base")


def _fake_port(tmp_path, files: dict) -> None:
    pkg = tmp_path / "repro_torch" / "fake"
    pkg.mkdir(parents=True)
    (tmp_path / "repro_torch" / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    for name, text in files.items():
        (pkg / name).write_text(text)


@pytest.mark.parametrize("heavy", ["torch", "jax"])
def test_wire_catches_module_scope_torch(tmp_path, monkeypatch, heavy):
    _fake_port(tmp_path, {"leaf.py": f"import {heavy}\n",
                          "root.py": "from repro_torch.fake import leaf\n"})
    monkeypatch.setattr(wire, "_SRC", tmp_path)
    findings = wire._closure_findings("repro_torch.fake.root")
    assert _codes(findings) == ["WIR001"]
    assert "leaf.py" in findings[0].location


def test_wire_deferred_imports_are_fine(tmp_path, monkeypatch):
    _fake_port(tmp_path, {"root.py": textwrap.dedent("""
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            import torch
        def body():
            import torch
            return torch
    """)})
    monkeypatch.setattr(wire, "_SRC", tmp_path)
    assert wire._closure_findings("repro_torch.fake.root") == []


def test_wire_catches_unpicklable_dataclass(tmp_path, monkeypatch):
    (tmp_path / "wire_fake_events.py").write_text(textwrap.dedent("""
        import dataclasses
        @dataclasses.dataclass
        class Good:
            rid: int = 0
        @dataclasses.dataclass
        class Bad:
            fn: object = lambda: None     # a lambda does not pickle
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(wire, "WIRE_DATACLASS_MODULES",
                        ("wire_fake_events",))
    findings = wire._pickle_findings()
    assert _codes(findings) == ["WIR002"]
    assert findings[0].location == "wire_fake_events.Bad"


def test_wire_engine_config_holds_primitives_none_included(monkeypatch):
    import torch

    from repro_torch.serving import backend
    from repro_torch.serving.engine import EngineConfig
    assert backend._engine_config_wire(EngineConfig())["chunk_tokens"] \
        is None
    assert wire._wire_dict_findings() == []

    def leaky(config):
        return dict(dataclasses.asdict(config), dtype=torch.bfloat16)
    monkeypatch.setattr(backend, "_engine_config_wire", leaky)
    findings = wire._wire_dict_findings()
    assert _codes(findings) == ["WIR003"]
    assert "dtype" in findings[0].location


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_report_and_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.cli import main
    report = tmp_path / "report.json"
    rc = main(["--only", "host-sync", "--only", "concurrency",
               "--report", str(report)])
    assert rc == 0
    data = json.loads(report.read_text())
    assert data["analyzers_run"] == ["host-sync", "concurrency"]
    assert data["counts"]["errors"] == 0
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ANALYZERS:
        assert name in out


def test_cli_exits_1_on_a_finding(tmp_path, monkeypatch):
    from repro_torch.analysis.cli import main
    serving = tmp_path / "serving"
    serving.mkdir()
    _engine_copy(serving, FINISH,
                 '        n = self._buf["emitted"].item()\n' + FINISH)
    (serving / "cache.py").write_text(CACHE.read_text())
    monkeypatch.setattr(host_sync, "_SERVING", serving)
    report = tmp_path / "report.json"
    assert main(["--only", "host-sync", "--report", str(report)]) == 1
    assert json.loads(report.read_text())["counts"]["errors"] == 1
    assert main(["--only", "host-sync", "--suppress", "SYN001"]) == 0


def test_cli_rejects_unknown_analyzer():
    from repro_torch.analysis.cli import main
    assert main(["--only", "nope"]) == 2


def test_module_entry_point_runs_clean_with_jax_and_repro_blocked():
    """``python -m repro_torch.analysis --all`` exits 0 on the tree and
    loads nothing of JAX or the reference package."""
    script = textwrap.dedent("""
        import importlib.abc, runpy, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
        sys.meta_path.insert(0, Blk())
        sys.argv = ["repro_torch.analysis", "--all"]
        runpy.run_module("repro_torch.analysis", run_name="__main__")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "host-sync, concurrency, wire: 0 error(s)" in out.stdout
