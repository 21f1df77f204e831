"""Static invariant suite for the port's serving stack.

``python -m repro_torch.analysis --all`` runs every analyzer and exits
nonzero on any finding; ``--report out.json`` writes the machine-
readable report (see report.Report.to_json). Individual analyzers run
with ``--only <name>``. Tier-1 runs the suite through
tests/test_torch_analysis.py.

Analyzers (all static: nothing runs on a device):

* ``host-sync``   — one host-to-device and one device-to-host copy per
                    decode chunk
* ``concurrency`` — class attrs written from two threads
* ``wire``        — pre-affinity import closure + pipe picklability

The other three guarantees of ``repro.analysis`` live elsewhere in the
port: ``donation`` (a donated buffer really aliases) is the engine's
``_check_addresses``, which raises before a graph replay if a captured
tensor moved; ``compile-keys`` (a bounded jit-cache key set) is one
captured step graph per engine; ``kernels`` (block shapes and budgets of
the Pallas kernels) is ``scripts/ptxas_report.py``'s registers, spills
and tensor-core instructions of every CUDA kernel instantiation, and
``Model(...)``'s refusal of a shape without a kernel.
"""
from repro_torch.analysis.report import Finding, Report

__all__ = ["Finding", "Report", "ANALYZERS", "run_analyzers"]

# name -> import path of a module exposing run() -> list[Finding]
ANALYZERS = {
    "host-sync": "repro_torch.analysis.host_sync",
    "concurrency": "repro_torch.analysis.concurrency",
    "wire": "repro_torch.analysis.wire",
}


def run_analyzers(names=None) -> Report:
    """Run the named analyzers (default: all) into one Report. An
    analyzer that crashes is itself a finding — the suite must not
    silently skip a broken gate."""
    import importlib
    import traceback

    report = Report()
    for name in (names or ANALYZERS):
        if name not in ANALYZERS:
            raise KeyError(f"unknown analyzer {name!r}; "
                           f"one of {sorted(ANALYZERS)}")
        try:
            findings = importlib.import_module(ANALYZERS[name]).run()
        except Exception:
            findings = [Finding(
                name, "ERR000", "analyzer",
                "analyzer crashed:\n" + traceback.format_exc())]
        report.analyzers_run.append(name)
        report.extend(findings)
    return report
