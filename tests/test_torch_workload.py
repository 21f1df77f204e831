"""The port's workload vocabulary against the JAX package's: trace
synthesis (every preset, every arrival kind), the JSONL files each
package writes and the other reads, prompt regeneration, the SLO
arithmetic (``SLOSpec.parse``, ``queue_limit``, ``shed_ttfc_threshold``,
``censored_ttfc_p95`` with its caveat, ``class_window``) and
``assemble_report``. All numpy, no model: equal means equal field for
field."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.workload import replay as jreplay  # noqa: E402
from repro.workload import slo as jslo  # noqa: E402
from repro.workload import traces as jtraces  # noqa: E402
from repro_torch.workload import replay as treplay  # noqa: E402
from repro_torch.workload import slo as tslo  # noqa: E402
from repro_torch.workload import traces as ttraces  # noqa: E402


def _records(trace) -> dict:
    d = dataclasses.asdict(trace)
    d["requests"] = [dataclasses.asdict(r) for r in trace.requests]
    return d


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("preset", sorted(jtraces.PRESETS))
def test_every_preset_synthesizes_jax_records(preset, seed):
    assert ttraces.PRESETS.keys() == jtraces.PRESETS.keys()
    assert (dataclasses.asdict(ttraces.PRESETS[preset])
            == dataclasses.asdict(jtraces.PRESETS[preset]))
    got = ttraces.synthesize(ttraces.get_preset(preset), seed=seed)
    want = jtraces.synthesize(jtraces.get_preset(preset), seed=seed)
    assert len(got.requests) > 0
    assert _records(got) == _records(want)
    assert got.classes() == want.classes()
    assert got.duration_s == want.duration_s


def _custom(mod, kind):
    return mod.TraceSpec(
        name=f"custom-{kind}", duration_s=40.0,
        arrival=mod.ArrivalSpec(kind=kind, rate_rps=2.5, period_s=17.0,
                                depth=1.3, burst_rate_rps=11.0,
                                calm_dwell_s=6.0, burst_dwell_s=2.0),
        lengths=mod.LengthSpec(prompt_median=40.0, prompt_sigma=0.9,
                               prompt_min=2, prompt_max=100,
                               output_medians=(4.0, 20.0, 90.0),
                               output_sigmas=(0.3, 0.5, 0.2),
                               output_weights=(0.5, 0.3, 0.2),
                               output_min=2, output_max=120),
        mix=mod.MixSpec(priorities=(("a", 1.0), ("b", 2.0), ("c", 0.5)),
                        n_tenants=5, tenant_skew=0.0,
                        models=(("m0", 1.0), ("m1", 3.0))),
        max_requests=150)


@pytest.mark.parametrize("kind", jtraces.ARRIVAL_KINDS)
def test_custom_spec_of_each_arrival_kind_matches_jax(kind):
    assert ttraces.ARRIVAL_KINDS == jtraces.ARRIVAL_KINDS
    got = ttraces.synthesize(_custom(ttraces, kind), seed=3)
    want = jtraces.synthesize(_custom(jtraces, kind), seed=3)
    assert _records(got) == _records(want)
    assert (ttraces.ArrivalSpec(kind=kind).mean_rate_rps()
            == jtraces.ArrivalSpec(kind=kind).mean_rate_rps())


def test_unknown_arrival_kind_and_preset_raise_in_both():
    for mod in (ttraces, jtraces):
        with pytest.raises(ValueError, match="unknown arrival kind"):
            mod.synthesize(mod.TraceSpec(
                arrival=mod.ArrivalSpec(kind="weibull")))
        with pytest.raises(ValueError, match="unknown trace preset"):
            mod.get_preset("nope")
        with pytest.raises(ValueError, match="neither a preset"):
            mod.load_or_synthesize("/nonexistent/trace.jsonl")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("preset", ["bursty", "diurnal-bursty"])
def test_jsonl_written_by_one_package_reads_back_equal_in_the_other(
        tmp_path, writer, preset):
    wmod, rmod = ((jtraces, ttraces) if writer == "jax"
                  else (ttraces, jtraces))
    trace = wmod.synthesize(wmod.get_preset(preset), seed=5)
    path = wmod.save_jsonl(trace, tmp_path / "t.jsonl")
    back = rmod.load_jsonl(path)
    assert _records(back) == _records(trace)
    assert back.spec == rmod.get_preset(preset)
    # and through the --trace resolver, as a path
    assert _records(rmod.load_or_synthesize(path)) == _records(trace)
    # the reading package's own synthesis of the same spec and seed
    assert back == rmod.synthesize(rmod.get_preset(preset), seed=5)


def test_jsonl_of_a_custom_spec_round_trips_across_packages(tmp_path):
    trace = ttraces.synthesize(_custom(ttraces, "diurnal_bursty"), seed=9)
    back = jtraces.load_jsonl(ttraces.save_jsonl(trace,
                                                 tmp_path / "c.jsonl"))
    assert back == jtraces.synthesize(_custom(jtraces, "diurnal_bursty"),
                                      seed=9)


def test_a_file_of_another_kind_is_refused(tmp_path):
    p = tmp_path / "x.jsonl"
    p.write_text('{"kind": "something"}\n')
    with pytest.raises(ValueError, match="not a repro trace file"):
        ttraces.load_jsonl(p)


@pytest.mark.parametrize("vocab", [256, 151936])
def test_prompt_tokens_and_build_request_match_jax(vocab):
    got_t = ttraces.synthesize(ttraces.get_preset("diurnal-bursty"), seed=1)
    want_t = jtraces.synthesize(jtraces.get_preset("diurnal-bursty"),
                                seed=1)
    for tr, jr in list(zip(got_t.requests, want_t.requests))[:40]:
        p = ttraces.prompt_tokens(tr, vocab)
        np.testing.assert_array_equal(p, jtraces.prompt_tokens(jr, vocab))
        assert p.dtype == np.int32 and p.shape == (tr.prompt_len,)
        treq = treplay.build_request(tr, vocab_size=vocab, deadline_s=2.5)
        jreq = jreplay.build_request(jr, vocab_size=vocab, deadline_s=2.5)
        np.testing.assert_array_equal(treq.prompt, jreq.prompt)
        assert treq.prompt.dtype == jreq.prompt.dtype
        for f in ("rid", "max_new_tokens", "deadline_s", "priority",
                  "tenant"):
            assert getattr(treq, f) == getattr(jreq, f), f


# ---------------------------------------------------------------------------
# SLO arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", [
    "interactive:0.5,batch:4.0", "interactive:0.5,batch:8.0",
    "a:1,b:2,c:3,d:4", "solo:0.25", "x:0.5:0.3,y:2.0:1.0",
    "interactive:0.5,,batch:4.0,"])
def test_slo_spec_parse_matches_jax(text):
    got, want = tslo.SLOSpec.parse(text), jslo.SLOSpec.parse(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.names() == want.names()
    assert [c.rank for c in got.classes] == list(range(len(got.classes)))
    assert (dataclasses.asdict(got.constraint)
            == dataclasses.asdict(want.constraint))
    for name in (*want.names(), "unknown", "default"):
        assert (dataclasses.asdict(got.cls(name))
                == dataclasses.asdict(want.cls(name)))


def test_slo_spec_parse_shares_step_down_by_rank():
    spec = tslo.SLOSpec.parse("a:1,b:2,c:3")
    assert [c.queue_frac for c in spec.classes] == [1.0, 0.5, 0.25]
    assert spec.cls("zzz").name == "c"        # unknown -> worst class
    assert spec.constraint.name == "a"


@pytest.mark.parametrize("text", ["", ",", "a", "a:1:0.5:9", "a:x",
                                  "a:-1", "a:1:0", "a:1:1.5", "a:1,a:2"])
def test_slo_spec_parse_rejects_garbage_like_jax(text):
    for mod in (tslo, jslo):
        with pytest.raises(ValueError):
            mod.SLOSpec.parse(text)


@pytest.mark.parametrize("max_queue", [None, 1, 2, 4, 7, 32, 64])
def test_queue_limit_and_shed_threshold_match_jax(max_queue):
    for text in ("interactive:0.5,batch:8.0", "x:0.5:0.3,y:2.0:0.01"):
        t, j = tslo.SLOSpec.parse(text), jslo.SLOSpec.parse(text)
        for tc, jc in zip(t.classes, j.classes):
            assert (tslo.queue_limit(tc, max_queue)
                    == jslo.queue_limit(jc, max_queue))
            for override in (None, 0.3, 5.0):
                assert (tslo.shed_ttfc_threshold(tc, override)
                        == jslo.shed_ttfc_threshold(jc, override))
    assert tslo.SHED_HEADROOM == jslo.SHED_HEADROOM


@pytest.mark.parametrize("seed", range(6))
def test_censored_ttfc_p95_matches_jax_on_random_inputs(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 30))
        ttfc = list(rng.exponential(0.4, n))
        lost = int(rng.integers(0, 10))
        cap = float(rng.choice([0.05, 0.5, 1.0, 4.0]))
        got = tslo.censored_ttfc_p95(ttfc, lost, cap)
        assert got == jslo.censored_ttfc_p95(ttfc, lost, cap)
    assert tslo.censored_ttfc_p95([], 0, 1.0) is None


def test_censored_ttfc_p95_keeps_the_reference_caveat():
    """The cap is returned even below every observation, exactly as in
    JAX: one observation of 2.0 s and one lost arrival at a 1.0 s cap
    give 1.0, not 2.0."""
    for mod in (tslo, jslo):
        assert mod.censored_ttfc_p95([2.0], 1, 1.0) == 1.0
        assert mod.censored_ttfc_p95([0.1, 0.2], 0, 9.0) == 0.2
        assert mod.censored_ttfc_p95([0.3] * 19, 1, 9.0) == 0.3
        assert mod.censored_ttfc_p95([0.3] * 18, 2, 9.0) == 9.0


@pytest.mark.parametrize("seed", range(4))
def test_class_window_matches_jax(seed):
    rng = np.random.default_rng(seed)
    spec_t = tslo.SLOSpec.parse("interactive:0.5,batch:8.0")
    spec_j = jslo.SLOSpec.parse("interactive:0.5,batch:8.0")
    for name in ("interactive", "batch"):
        for n in (0, 1, 5, 40):
            ttfc = list(rng.exponential(0.3, n))
            lat = list(rng.exponential(1.0, n))
            args = (name, ttfc, lat, int(rng.integers(0, 4)),
                    int(rng.integers(0, 3)))
            got = tslo.class_window(spec_t.cls(name), *args)
            want = jslo.class_window(spec_j.cls(name), *args)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert (dataclasses.asdict(tslo.class_window(None, *args))
                    == dataclasses.asdict(jslo.class_window(None, *args)))


@pytest.mark.parametrize("slo_text", [None, "interactive:0.5,batch:8.0"])
@pytest.mark.parametrize("seed", range(3))
def test_assemble_report_matches_jax(slo_text, seed):
    rng = np.random.default_rng(seed)
    tt = ttraces.synthesize(ttraces.get_preset("bursty"), seed=seed)
    jt = jtraces.synthesize(jtraces.get_preset("bursty"), seed=seed)
    names = ["interactive", "batch", "mystery"]
    done = [(str(rng.choice(names)),
             None if rng.random() < 0.1 else float(rng.exponential(0.4)),
             float(rng.exponential(2.0))) for _ in range(60)]
    shed = [str(rng.choice(names)) for _ in range(7)]
    failed = [str(rng.choice(names)) for _ in range(3)]
    kw = dict(done=done, shed=shed, failed=failed, duration_s=61.5,
              energy_j=812.25, time_scale=10.0, counts_visited=(2, 1, 4),
              final_n=1)
    got = treplay.assemble_report(
        tt, slo=tslo.SLOSpec.parse(slo_text) if slo_text else None, **kw)
    want = jreplay.assemble_report(
        jt, slo=jslo.SLOSpec.parse(slo_text) if slo_text else None, **kw)
    assert got.to_dict() == want.to_dict()
    empty = treplay.assemble_report(tt, slo=None, done=[], shed=[],
                                    failed=[], duration_s=0.0, energy_j=0.0)
    assert empty.to_dict() == jreplay.assemble_report(
        jt, slo=None, done=[], shed=[], failed=[], duration_s=0.0,
        energy_j=0.0).to_dict()
