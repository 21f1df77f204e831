"""The port's virtual-time fleet simulator against the JAX package's: the
simulator touches no device and runs the port's copy of the scheduler
and of the SLO arithmetic, so for the same trace and knobs its
``ReplayReport.to_dict()`` must equal JAX's bit for bit — under the
mean-energy and the SLO-constrained objective, over the ``bursty`` preset
and 300 s of ``diurnal-bursty``, with and without client deadlines."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.workload import sim as jsim  # noqa: E402
from repro.workload import slo as jslo  # noqa: E402
from repro.workload import traces as jtraces  # noqa: E402
from repro_torch.workload import sim as tsim  # noqa: E402
from repro_torch.workload import slo as tslo  # noqa: E402
from repro_torch.workload import traces as ttraces  # noqa: E402

SLO_TEXT = "interactive:0.5,batch:8.0"
DEADLINES = {"interactive": 1.2, "batch": 30.0, "default": 30.0}
KW = dict(feasible_counts=[1, 2, 3, 4], window=32, window_s=20.0,
          max_queue=64, epsilon=0.05)


def _trace(mod, name):
    spec = mod.get_preset("diurnal-bursty" if name == "diurnal-bursty-300"
                          else name)
    if name == "diurnal-bursty-300":
        spec = dataclasses.replace(spec, duration_s=300.0)
    return mod.synthesize(spec, seed=1)


def _both(trace_name, objective, with_slo, deadlines, **extra):
    out = []
    for mod, slo_mod, tr_mod in ((tsim, tslo, ttraces),
                                 (jsim, jslo, jtraces)):
        out.append(mod.simulate(
            _trace(tr_mod, trace_name), objective=objective,
            slo=slo_mod.SLOSpec.parse(SLO_TEXT) if with_slo else None,
            deadline_by_class=DEADLINES if deadlines else None,
            **KW, **extra).to_dict())
    return out


@pytest.mark.parametrize("deadlines", [False, True])
@pytest.mark.parametrize("objective,with_slo", [
    ("energy", False), ("energy", True), ("energy_under_slo", True)])
@pytest.mark.parametrize("trace_name", ["bursty", "diurnal-bursty-300"])
def test_simulate_report_equals_jax_bit_for_bit(trace_name, objective,
                                                with_slo, deadlines):
    got, want = _both(trace_name, objective, with_slo, deadlines)
    assert got == want
    assert got["n_done"] + got["n_shed"] + got["n_failed"] \
        == got["n_requests"] > 0
    assert set(got["counts_visited"]) <= set(KW["feasible_counts"])


@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_with_another_fleet_and_seed_equals_jax(seed):
    """A fleet off the defaults and another scheduler seed: the Amdahl
    split, the power model and the epsilon-greedy stream all agree."""
    got = tsim.simulate(
        _trace(ttraces, "bursty"), objective="energy_under_slo",
        slo=tslo.SLOSpec.parse("interactive:0.3,batch:4.0:0.4"),
        fleet=tsim.FleetModel(cores=8.0, parallel_frac=0.8,
                              p_container_w=2.0),
        feasible_counts=[1, 2, 4, 8], window=16, window_s=None,
        max_queue=32, shed_p95_s=None, epsilon=0.2, seed=seed).to_dict()
    want = jsim.simulate(
        _trace(jtraces, "bursty"), objective="energy_under_slo",
        slo=jslo.SLOSpec.parse("interactive:0.3,batch:4.0:0.4"),
        fleet=jsim.FleetModel(cores=8.0, parallel_frac=0.8,
                              p_container_w=2.0),
        feasible_counts=[1, 2, 4, 8], window=16, window_s=None,
        max_queue=32, shed_p95_s=None, epsilon=0.2, seed=seed).to_dict()
    assert got == want


def test_simulate_is_deterministic_and_needs_an_slo_for_its_objective():
    trace = _trace(ttraces, "bursty")
    slo = tslo.SLOSpec.parse(SLO_TEXT)
    a = tsim.simulate(trace, objective="energy_under_slo", slo=slo, **KW)
    b = tsim.simulate(trace, objective="energy_under_slo", slo=slo, **KW)
    assert a == b
    for mod in (tsim, jsim):
        with pytest.raises(ValueError, match="needs an SLOSpec"):
            mod.simulate(trace, objective="energy_under_slo", **KW)


def test_fleet_model_arithmetic_equals_jax():
    t, j = tsim.FleetModel(), jsim.FleetModel()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    tr = _trace(ttraces, "bursty").requests[0]
    jr = _trace(jtraces, "bursty").requests[0]
    for n in (1, 2, 3, 4, 8):
        assert t.rate(n) == j.rate(n)
        for busy in (0, 1, n, n + 2):
            assert t.power_w(n, busy) == j.power_w(n, busy)
    assert t.work_tokens(tr) == j.work_tokens(jr)
    assert t.prefill_tokens(tr) == j.prefill_tokens(jr)
