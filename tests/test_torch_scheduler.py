"""The port's copies of the numpy-only core (``core/splitter.py``,
``core/energy_model.py``, ``core/scheduler.py``) against the JAX
package's.

Each behaviour test of ``tests/test_scheduler.py``, ``test_splitter.py``
and ``test_energy_model.py`` runs as one parametrised case per package
(``side``), so the copy is held to every contract the original is. The
differential tests feed both schedulers the same seeded observation
sequences (the tx2 and orin simulators with seeded noise; all four
objectives; ε 0 and 0.2 with a seed) and require the same ``pick()``
sequence, the same ``best()`` and fitted coefficients within 1e-9
relative.
"""
from __future__ import annotations

import collections
import types

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import energy_model as jem  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import splitter as jsplit  # noqa: E402
from repro_torch.core import energy_model as tem  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import splitter as tsplit  # noqa: E402

SIDES = {"jax": types.SimpleNamespace(em=jem, sched=jsched, split=jsplit),
         "port": types.SimpleNamespace(em=tem, sched=tsched, split=tsplit)}


@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


def _drive(sched, device, counts):
    for n in counts:
        sched.observe(n, device.time(n), device.energy(n))


# ---------------------------------------------------------------------------
# scheduler behaviour (tests/test_scheduler.py), both packages
# ---------------------------------------------------------------------------
def test_scheduler_converges_tx2_energy(side):
    dev = side.em.tx2_model()
    sched = side.sched.DivideAndSaveScheduler(list(range(1, 7)),
                                              objective="energy",
                                              epsilon=0.0)
    _drive(sched, dev, [1, 2, 3, 4, 5, 6])
    assert sched.pick() == min(range(1, 7), key=dev.energy)


def test_scheduler_converges_orin_time(side):
    dev = side.em.orin_model()
    sched = side.sched.DivideAndSaveScheduler(list(range(1, 13)),
                                              objective="time", epsilon=0.0)
    _drive(sched, dev, [1, 4, 8, 12])
    assert sched.pick() >= 8


def test_scheduler_bootstrap_explores(side):
    sched = side.sched.DivideAndSaveScheduler([1, 2, 4, 8], epsilon=0.0)
    assert sched.pick() in (1, 2, 4, 8)
    assert sched.n_observations == 0


def test_deadline_constrains_choice(side):
    dev = side.em.tx2_model()
    sched = side.sched.DivideAndSaveScheduler(
        list(range(1, 7)), objective="energy_under_deadline",
        deadline_s=dev.time(4) * 1.02, epsilon=0.0)
    _drive(sched, dev, [1, 2, 3, 4, 5, 6])
    assert dev.time(sched.pick()) <= dev.time(4) * 1.02


def test_deadline_infeasible_falls_back_to_fastest(side):
    dev = side.em.tx2_model()
    sched = side.sched.DivideAndSaveScheduler(
        list(range(1, 7)), objective="energy_under_deadline",
        deadline_s=1.0, epsilon=0.0)
    _drive(sched, dev, [1, 2, 3, 4, 5, 6])
    assert sched.pick() == min(range(1, 7), key=dev.time)


def test_summary_contains_fitted_models(side):
    dev = side.em.orin_model()
    sched = side.sched.DivideAndSaveScheduler(list(range(1, 13)),
                                              epsilon=0.0)
    _drive(sched, dev, [1, 6, 12])
    s = sched.summary()
    assert s["observations"] == 3 and s["time_model"] is not None
    assert s["choice"] in range(1, 13)
    assert set(s) == {"feasible", "observations", "time_model",
                      "energy_model", "ttfc_model", "slo_ttfc_p95_s",
                      "choice"}


def test_best_is_exploitation_only(side):
    dev = side.em.tx2_model()
    sched = side.sched.DivideAndSaveScheduler(list(range(1, 7)),
                                              objective="energy",
                                              epsilon=0.5, seed=1)
    _drive(sched, dev, [2, 5])
    assert sched.best() == min((2, 5), key=dev.energy)
    _drive(sched, dev, [1, 3, 4, 6])
    assert sched.best() == sched._argmin()


def test_rejects_empty_feasible_set(side):
    with pytest.raises(ValueError):
        side.sched.DivideAndSaveScheduler([])


def test_untrusted_fit_deadline_fallback_uses_observed_means(side):
    sched = side.sched.DivideAndSaveScheduler(
        [1, 2, 4], objective="energy_under_deadline", deadline_s=0.5,
        epsilon=0.0)
    for n, t in ((1, 5.0), (2, 1.0), (4, 9.0)):
        sched.observe(n, t, t * 40.0)
    misfit = side.em.FittedModel("quad", (0.0, -1.0, 10.0), rmse=100.0)
    sched.time_model = sched.energy_model = misfit
    assert sched._argmin() == sched.pick() == sched.best() == 2


def test_poor_fit_falls_back_to_observed_minimum(side):
    ns = [1, 2, 4, 8, 16, 32, 64, 128]
    times = [1.0, 0.82, 0.83, 0.68, 0.71, 1.68, 2.07, 2.60]
    sched = side.sched.DivideAndSaveScheduler(ns, objective="energy",
                                              epsilon=0.0)
    for n, t in zip(ns, times):
        sched.observe(n, t, t * 0.8)
    assert sched.pick() == 8


def _drive_slo(sched, windows_per_count=10):
    tails = {1: 2.0, 2: 0.9, 3: 0.25, 4: 0.2}
    energy = {1: 10.0, 2: 8.0, 3: 9.0, 4: 11.0}
    for n, q in tails.items():
        for _ in range(windows_per_count):
            sched.observe(n, 1.0, energy[n], ttfc_p95_s=q)


def test_energy_under_slo_skips_infeasible_counts(side):
    sched = side.sched.DivideAndSaveScheduler(
        [1, 2, 3, 4], objective="energy_under_slo", slo_ttfc_p95_s=0.5,
        epsilon=0.0)
    _drive_slo(sched)
    assert sched.pick() == 3
    assert sched.predict_ttfc_p95(1) > 0.5
    assert sched.predict_ttfc_p95(3) <= 0.5


def test_energy_under_slo_infeasible_everywhere_minimises_tail(side):
    sched = side.sched.DivideAndSaveScheduler(
        [1, 2, 3, 4], objective="energy_under_slo", slo_ttfc_p95_s=0.05,
        epsilon=0.0)
    _drive_slo(sched)
    assert sched.pick() == 4


def test_energy_under_slo_requires_target(side):
    with pytest.raises(ValueError, match="slo_ttfc_p95_s"):
        side.sched.DivideAndSaveScheduler([1, 2],
                                          objective="energy_under_slo")


def test_quantile_aggregation_is_tail_not_mean(side):
    sched = side.sched.DivideAndSaveScheduler(
        [1, 2, 3], objective="energy_under_slo", slo_ttfc_p95_s=0.5,
        epsilon=0.0)
    for q in [0.1] * 7 + [2.0] * 3:
        sched.observe(1, 1.0, 5.0, ttfc_p95_s=q)
    for n, e in ((2, 6.0), (3, 7.0)):
        for _ in range(10):
            sched.observe(n, 1.0, e, ttfc_p95_s=0.2)
    assert sched.predict_ttfc_p95(1) > 0.5
    assert sched.pick() == 2


def test_quantile_tail_tolerates_rare_bad_window(side):
    sched = side.sched.DivideAndSaveScheduler(
        [1, 2], objective="energy_under_slo", slo_ttfc_p95_s=0.5,
        epsilon=0.0)
    assert sched._tail_of([0.2] * 9 + [2.0]) <= 0.5


def test_quantile_prediction_none_before_samples(side):
    sched = side.sched.DivideAndSaveScheduler(
        [1, 2], objective="energy_under_slo", slo_ttfc_p95_s=0.5,
        epsilon=0.0)
    sched.observe(1, 1.0, 5.0)
    assert sched.predict_ttfc_p95(1) is None
    sched.observe(1, 1.0, 5.0, ttfc_p95_s=0.3)
    assert sched.predict_ttfc_p95(1) == pytest.approx(0.3)


def test_persistent_exploration_revisits_known_counts(side):
    sched = side.sched.DivideAndSaveScheduler([1, 2, 3], objective="energy",
                                              epsilon=0.5, seed=0)
    for n in (1, 2, 3):
        for _ in range(3):
            sched.observe(n, 1.0 + n * 0.1, 5.0 + n)
    picks = collections.Counter(sched.pick() for _ in range(200))
    assert len(picks) == 3 and picks[1] > 100


def test_the_port_leaves_out_the_tpu_chunk_model():
    assert hasattr(jsched.DivideAndSaveScheduler, "chunk_for")
    assert not hasattr(tsched.DivideAndSaveScheduler, "chunk_for")
    assert not hasattr(tem, "TpuSplitPoint")


# ---------------------------------------------------------------------------
# the same observations give the same picks
# ---------------------------------------------------------------------------
OBJECTIVES = ["energy", "time", "energy_under_deadline", "energy_under_slo"]


def _close_rel(a, b, rel=1e-9):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert np.all(np.abs(a - b) <= rel * np.maximum(np.abs(b), 1e-300)), \
        (a, b)


def _same_model(jm, tm):
    if jm is None:
        assert tm is None
        return
    assert tm.kind == jm.kind
    _close_rel(tm.coef, jm.coef)
    _close_rel(tm.rmse, jm.rmse)


@pytest.mark.parametrize("device", ["tx2", "orin"])
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("epsilon", [0.0, 0.2])
def test_same_observations_give_jax_picks(device, objective, epsilon):
    """Both schedulers pick, the seeded simulator answers the JAX pick
    with noise (time, energy and a ttfc tail), both observe it; 40 rounds.
    Picks, ``best()`` and the fitted models agree throughout."""
    counts = list(range(1, 7)) if device == "tx2" else list(range(1, 13))
    jdev = getattr(jem, f"{device}_model")()
    kw = dict(objective=objective, epsilon=epsilon, seed=5)
    if objective == "energy_under_deadline":
        kw["deadline_s"] = jdev.time(4) * 1.05
    if objective == "energy_under_slo":
        kw["slo_ttfc_p95_s"] = 0.3
    js = jsched.DivideAndSaveScheduler(counts, **kw)
    ts = tsched.DivideAndSaveScheduler(counts, **kw)
    rng = np.random.default_rng(11)
    picks = []
    for _ in range(40):
        n = js.pick()
        assert ts.pick() == n
        picks.append(n)
        t = jdev.time(n) * (1 + 0.05 * rng.standard_normal())
        e = jdev.energy(n) * (1 + 0.05 * rng.standard_normal())
        q = 1.2 / n * (1 + 0.1 * rng.standard_normal())
        js.observe(n, t, e, ttfc_p95_s=q)
        ts.observe(n, t, e, ttfc_p95_s=q)
        for name in ("time_model", "energy_model", "ttfc_model"):
            _same_model(getattr(js, name), getattr(ts, name))
        assert ts.best() == js.best()
    assert len(set(picks)) >= 3
    # summary() draws a pick too: the streams stay in step
    jsum, tsum = js.summary(), ts.summary()
    assert tsum["choice"] == jsum["choice"]
    assert tsum["feasible"] == jsum["feasible"]


# ---------------------------------------------------------------------------
# splitter (tests/test_splitter.py), both packages, and equal outputs
# ---------------------------------------------------------------------------
@given(st.lists(st.integers(), max_size=200), st.integers(1, 32))
@settings(max_examples=100, deadline=None)
def test_split_combine_roundtrip(items, n):
    for side in SIDES.values():
        segs = side.split.split(items, n)
        assert side.split.combine(segs) == list(items) and len(segs) == n
    assert tsplit.split(items, n) == jsplit.split(items, n)


@given(st.integers(0, 10_000), st.integers(1, 64))
@settings(max_examples=100, deadline=None)
def test_segment_sizes_maximally_equal(n_items, n_segments):
    sizes = tsplit.segment_sizes(n_items, n_segments)
    assert sizes == jsplit.segment_sizes(n_items, n_segments)
    assert sum(sizes) == n_items and len(sizes) == n_segments
    assert max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)


@given(st.integers(1, 97), st.integers(1, 12), st.integers(0, 3))
@settings(max_examples=50, deadline=None)
def test_split_array_roundtrip(n_frames, n_segments, extra_dims):
    shape = (n_frames,) + (2,) * extra_dims
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    parts = tsplit.split_array(x, n_segments)
    want = jsplit.split_array(x, n_segments)
    assert len(parts) == n_segments
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsplit.combine_arrays(parts), x)


def test_zero_segments_rejected(side):
    with pytest.raises(ValueError):
        side.split.segment_sizes(10, 0)


# ---------------------------------------------------------------------------
# energy models (tests/test_energy_model.py), both packages
# ---------------------------------------------------------------------------
@given(st.tuples(st.floats(0.001, 0.1), st.floats(-0.5, -0.01),
                 st.floats(0.8, 1.5)))
@settings(max_examples=30, deadline=None)
def test_quadratic_fit_recovers_coefficients(coef):
    x = np.arange(1, 13, dtype=float)
    y = tem.eval_model("quad", coef, x)
    fit = tem.fit_quadratic(x, y)
    assert fit.rmse < 1e-8
    np.testing.assert_allclose(fit.coef, coef, rtol=1e-5, atol=1e-7)
    _same_model(jem.fit_quadratic(x, y), fit)


def test_exponential_fit_recovers_curve(side):
    x = np.arange(1, 13, dtype=float)
    y = side.em.eval_model("exp", (0.33, 1.77, 0.98), x)
    np.testing.assert_allclose(side.em.fit_exponential(x, y)(x), y,
                               atol=5e-3)


def test_fits_equal_jax_on_noisy_samples():
    rng = np.random.default_rng(4)
    x = np.arange(1, 13, dtype=float)
    for kind, coef in jem.PAPER_MODELS.values():
        y = jem.eval_model(kind, coef, x) * (1 + 0.02 * rng.standard_normal(
            x.shape))
        for fit in ("fit_quadratic", "fit_exponential", "fit_best"):
            _same_model(getattr(jem, fit)(x, y), getattr(tem, fit)(x, y))


def test_fit_best_picks_the_right_family(side):
    x = np.arange(1, 13, dtype=float)
    yq = side.em.eval_model("quad", (0.026, -0.21, 1.17), x)
    ye = side.em.eval_model("exp", (0.33, 1.77, 0.98), x)
    assert side.em.fit_best(x, yq).kind == "quad"
    assert side.em.fit_best(x, ye).kind == "exp"


def test_paper_constants_are_jax_s():
    assert tem.PAPER_REF == jem.PAPER_REF
    assert tem.PAPER_MODELS == jem.PAPER_MODELS


def test_paper_models_normalised_near_one_at_benchmark(side):
    for (dev, metric), (kind, coef) in side.em.PAPER_MODELS.items():
        v1 = float(side.em.eval_model(kind, coef, 1.0))
        assert 0.8 < v1 < 1.2, (dev, metric, v1)


def test_paper_model_argmin_matches_paper_conclusions(side):
    em = side.em
    assert em.FittedModel(*em.PAPER_MODELS[("tx2", "time")],
                          rmse=0.0).argmin(6) == 4
    assert em.FittedModel(*em.PAPER_MODELS[("tx2", "energy")],
                          rmse=0.0).argmin(6) == 4
    assert em.FittedModel(*em.PAPER_MODELS[("orin", "time")],
                          rmse=0.0).argmin(12) == 12


@pytest.mark.parametrize("name", ["tx2", "orin"])
def test_device_model_reproduces_benchmark_refs_and_jax(side, name):
    m = getattr(side.em, f"{name}_model")()
    ref = side.em.PAPER_REF[name]
    assert abs(m.time(1) - ref["time_s"]) / ref["time_s"] < 0.10
    assert abs(m.energy(1) - ref["energy_j"]) / ref["energy_j"] < 0.10
    assert abs(m.power(1) - ref["power_w"]) / ref["power_w"] < 0.10
    j = getattr(jem, f"{name}_model")()
    for n in range(1, 14):
        assert (m.time(n), m.energy(n), m.power(n)) == (
            j.time(n), j.energy(n), j.power(n))
    for c in (0.005, 0.5, 1.0, 2.5, 4.0):
        assert m.single_container_time(c) == j.single_container_time(c)


def test_tx2_model_savings_match_paper(side):
    m = side.em.tx2_model()
    t1, e1 = m.time(1), m.energy(1)
    assert abs((1 - m.time(2) / t1) - 0.19) < 0.06
    assert abs((1 - m.energy(2) / e1) - 0.10) < 0.06
    assert abs((1 - m.time(4) / t1) - 0.25) < 0.06
    assert abs((1 - m.energy(4) / e1) - 0.15) < 0.06
    assert m.time(6) > m.time(4) and m.energy(6) > m.energy(4)


def test_orin_model_savings_match_paper(side):
    m = side.em.orin_model()
    t1, e1, p1 = m.time(1), m.energy(1), m.power(1)
    assert abs((1 - m.time(2) / t1) - 0.43) < 0.08
    assert abs((1 - m.energy(2) / e1) - 0.25) < 0.08
    assert abs((1 - m.time(4) / t1) - 0.62) < 0.08
    assert abs((1 - m.energy(4) / e1) - 0.40) < 0.08
    assert abs((1 - m.time(12) / t1) - 0.70) < 0.08
    assert abs((1 - m.energy(12) / e1) - 0.43) < 0.08
    assert abs((m.power(12) / p1 - 1) - 0.84) < 0.25


def test_power_rises_while_energy_falls(side):
    for m in (side.em.tx2_model(), side.em.orin_model()):
        best = 4 if m.cores == 4 else 12
        assert m.power(best) > m.power(1)
        assert m.energy(best) < m.energy(1) and m.time(best) < m.time(1)


def test_single_container_cores_sweep_flattens(side):
    m = side.em.tx2_model()
    t = [m.single_container_time(c) for c in (1, 2, 3, 4)]
    assert t[0] > t[1] > t[2] > t[3]
    assert t[2] - t[3] < 0.4 * (t[0] - t[1])


def test_fitted_forms_match_device_model_curves(side):
    m = side.em.orin_model()
    xs = np.arange(1, 13, dtype=float)
    times = np.array([m.time(int(n)) for n in xs]) / m.time(1)
    fit = side.em.fit_best(xs, times)
    assert fit.rmse < 0.05 and fit.argmin(12) >= 8
