"""Seeded, deterministic workload-trace generators: the port's own copy
of ``repro.workload.traces`` (the same draws, presets and file format, so
the same spec and seed give the same records in both packages, and a
trace file written by one reads back equal in the other).

Every scheduling claim in this repo used to be measured against synthetic
same-shape waves; real edge traffic is bursty and heterogeneous
("Performance Characterization of Containerized DNN Training and
Inference on Edge Accelerators", PAPERS.md). This module generates the
realistic load: a ``Trace`` is a time-ordered sequence of
``TraceRequest`` records drawn from

* an **arrival process** — homogeneous Poisson, diurnal-modulated
  Poisson (nonhomogeneous, generated by thinning), or Markov-modulated
  bursty (a 2-state MMPP: calm/burst rates with exponential dwell
  times), or the diurnal×bursty product of the last two;
* **length distributions** — lognormal prompt lengths and a lognormal
  *mixture* for output lengths (short chat turns + a long-generation
  tail), both clamped to configured bounds;
* a **class mix** — priority classes, a Zipf-skewed tenant population,
  and a model-family mix (one entry today; the heterogeneous-fleet
  ROADMAP item consumes the rest).

Everything is driven by one ``numpy`` Generator seeded from
``TraceSpec``-external ``seed``, with a fixed per-request draw order, so
the same ``(spec, seed)`` always yields a bit-identical trace. Prompts
are NOT materialised: each record carries ``prompt_seed`` and the
replayer regenerates the token ids deterministically, keeping traces
small and the JSONL round-trip exact.

This module stays import-light (numpy only) and every dataclass here is
a frozen, picklable wire type.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import numpy as np

ARRIVAL_KINDS = ("poisson", "diurnal", "bursty", "diurnal_bursty")


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival. ``arrival_s`` is the offset from trace start;
    ``prompt_seed`` regenerates the prompt token ids at replay time
    (``np.random.default_rng(prompt_seed).integers(0, vocab,
    prompt_len)``), so records stay a handful of scalars."""
    rid: int = 0
    arrival_s: float = 0.0
    prompt_len: int = 8
    max_new_tokens: int = 8
    priority: str = "default"
    tenant: str = "t0"
    model: str = ""
    prompt_seed: int = 0


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Arrival process. ``rate_rps`` is the calm/base rate; ``diurnal``
    modulates it by ``1 + depth·sin(2πt/period)``; ``bursty`` switches
    between ``rate_rps`` and ``burst_rate_rps`` with exponential dwell
    times (mean ``calm_dwell_s`` / ``burst_dwell_s``);
    ``diurnal_bursty`` applies the diurnal envelope to both MMPP
    states."""
    kind: str = "poisson"
    rate_rps: float = 2.0
    period_s: float = 120.0
    depth: float = 0.8
    burst_rate_rps: float = 10.0
    calm_dwell_s: float = 30.0
    burst_dwell_s: float = 5.0

    def mean_rate_rps(self) -> float:
        """Analytic long-run arrival rate of the configured process (the
        property tests compare empirical inter-arrival means against
        this). The diurnal envelope averages to 1, so it drops out."""
        if self.kind in ("poisson", "diurnal"):
            return self.rate_rps
        dwell = self.calm_dwell_s + self.burst_dwell_s
        return (self.calm_dwell_s * self.rate_rps
                + self.burst_dwell_s * self.burst_rate_rps) / dwell


@dataclasses.dataclass(frozen=True)
class LengthSpec:
    """Prompt lengths: one lognormal (median/σ in log-space). Output
    lengths: a weighted lognormal mixture — component ``i`` has median
    ``output_medians[i]`` and sigma ``output_sigmas[i]``."""
    prompt_median: float = 24.0
    prompt_sigma: float = 0.6
    prompt_min: int = 4
    prompt_max: int = 256
    output_medians: tuple = (8.0, 48.0)
    output_sigmas: tuple = (0.5, 0.4)
    output_weights: tuple = (0.8, 0.2)
    output_min: int = 1
    output_max: int = 256


@dataclasses.dataclass(frozen=True)
class MixSpec:
    """Request classes. ``priorities``/``models`` are (name, weight)
    pairs; tenants are ``t0..t{n-1}`` with Zipf(``tenant_skew``)
    popularity (0 = uniform)."""
    priorities: tuple = (("interactive", 0.8), ("batch", 0.2))
    n_tenants: int = 4
    tenant_skew: float = 1.0
    models: tuple = (("qwen3-0.6b", 1.0),)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str = "trace"
    duration_s: float = 60.0
    arrival: ArrivalSpec = ArrivalSpec()
    lengths: LengthSpec = LengthSpec()
    mix: MixSpec = MixSpec()
    max_requests: int = 100_000     # hard cap, guards runaway rates


@dataclasses.dataclass(frozen=True)
class Trace:
    """A generated (or loaded) workload trace: requests are time-ordered
    and ``spec`` records full provenance, so a trace file is
    self-describing and regenerable."""
    name: str = "trace"
    seed: int = 0
    spec: TraceSpec = TraceSpec()
    requests: tuple = ()

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    def classes(self) -> tuple:
        return tuple(sorted({r.priority for r in self.requests}))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------
def _arrival_times(spec: ArrivalSpec, duration_s: float, cap: int,
                   rng: np.random.Generator) -> list[float]:
    if spec.kind not in ARRIVAL_KINDS:
        raise ValueError(f"unknown arrival kind {spec.kind!r} "
                         f"(one of {ARRIVAL_KINDS})")
    out: list[float] = []
    if spec.kind == "poisson":
        t = 0.0
        while len(out) < cap:
            t += rng.exponential(1.0 / spec.rate_rps)
            if t > duration_s:
                break
            out.append(t)
        return out
    # the three modulated processes share one thinning loop: candidates
    # arrive at the envelope rate ``lam_max`` and survive with
    # probability λ(t)/lam_max — exact for nonhomogeneous Poisson
    diurnal = spec.kind in ("diurnal", "diurnal_bursty")
    bursty = spec.kind in ("bursty", "diurnal_bursty")
    depth = min(max(spec.depth, 0.0), 0.99) if diurnal else 0.0
    base_max = max(spec.rate_rps, spec.burst_rate_rps) if bursty \
        else spec.rate_rps
    lam_max = base_max * (1.0 + depth)
    state_burst = False
    # first dwell drawn up front so state flips are part of the single
    # deterministic draw stream
    next_flip = rng.exponential(spec.calm_dwell_s) if bursty else math.inf
    t = 0.0
    while len(out) < cap:
        t += rng.exponential(1.0 / lam_max)
        if t > duration_s:
            break
        while bursty and t >= next_flip:
            state_burst = not state_burst
            next_flip += rng.exponential(
                spec.burst_dwell_s if state_burst else spec.calm_dwell_s)
        lam = spec.burst_rate_rps if (bursty and state_burst) \
            else spec.rate_rps
        if diurnal:
            lam *= 1.0 + depth * math.sin(2.0 * math.pi * t / spec.period_s)
        if rng.random() < lam / lam_max:
            out.append(t)
    return out


def _lognormal_int(rng: np.random.Generator, median: float, sigma: float,
                   lo: int, hi: int) -> int:
    v = rng.lognormal(math.log(median), sigma)
    return int(min(max(round(v), lo), hi))


def _weighted_names(pairs) -> tuple[list[str], np.ndarray]:
    names = [str(n) for n, _ in pairs]
    w = np.asarray([float(v) for _, v in pairs], dtype=float)
    if len(w) == 0 or w.sum() <= 0:
        raise ValueError(f"need positive weights, got {pairs!r}")
    return names, w / w.sum()


def synthesize(spec: TraceSpec, seed: int = 0) -> Trace:
    """Generate a trace: same ``(spec, seed)`` → bit-identical result.
    One rng stream, fixed draw order (arrivals first, then per-request
    fields in declaration order)."""
    rng = np.random.default_rng(seed)
    times = _arrival_times(spec.arrival, spec.duration_s,
                           spec.max_requests, rng)
    pri_names, pri_w = _weighted_names(spec.mix.priorities)
    mdl_names, mdl_w = _weighted_names(spec.mix.models)
    nt = max(spec.mix.n_tenants, 1)
    tw = np.asarray([1.0 / (k + 1) ** spec.mix.tenant_skew
                     for k in range(nt)])
    tw /= tw.sum()
    ln = spec.lengths
    ow = np.asarray(ln.output_weights, dtype=float)
    ow /= ow.sum()
    reqs = []
    for rid, t in enumerate(times):
        plen = _lognormal_int(rng, ln.prompt_median, ln.prompt_sigma,
                              ln.prompt_min, ln.prompt_max)
        comp = int(rng.choice(len(ow), p=ow))
        out_len = _lognormal_int(rng, ln.output_medians[comp],
                                 ln.output_sigmas[comp],
                                 ln.output_min, ln.output_max)
        reqs.append(TraceRequest(
            rid=rid, arrival_s=float(t), prompt_len=plen,
            max_new_tokens=out_len,
            priority=pri_names[int(rng.choice(len(pri_w), p=pri_w))],
            tenant=f"t{int(rng.choice(nt, p=tw))}",
            model=mdl_names[int(rng.choice(len(mdl_w), p=mdl_w))],
            prompt_seed=int(rng.integers(0, 2**31 - 1))))
    return Trace(name=spec.name, seed=seed, spec=spec,
                 requests=tuple(reqs))


def prompt_tokens(req: TraceRequest, vocab_size: int) -> np.ndarray:
    """The request's prompt token ids, regenerated deterministically
    from ``prompt_seed`` (replay-side; traces never store token
    arrays)."""
    return np.random.default_rng(req.prompt_seed).integers(
        0, vocab_size, (req.prompt_len,), dtype=np.int32)


# ---------------------------------------------------------------------------
# JSONL persistence — exact round-trip
# ---------------------------------------------------------------------------
def _spec_from_dict(d: dict) -> TraceSpec:
    def tup(v):
        # json has no tuples; every sequence field is a tuple by schema
        if isinstance(v, list):
            return tuple(tup(x) for x in v)
        return v
    return TraceSpec(
        name=d["name"], duration_s=d["duration_s"],
        arrival=ArrivalSpec(**d["arrival"]),
        lengths=LengthSpec(**{k: tup(v) for k, v in d["lengths"].items()}),
        mix=MixSpec(**{k: tup(v) for k, v in d["mix"].items()}),
        max_requests=d["max_requests"])


def save_jsonl(trace: Trace, path) -> str:
    """One header line (name/seed/spec provenance) then one line per
    request. Floats serialise via ``repr`` (json default), so finite
    values round-trip bit-exactly. The header's ``kind`` is the JAX
    package's ``"repro.trace"``, so each package reads the other's
    files."""
    path = pathlib.Path(path)
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "repro.trace", "name": trace.name,
                            "seed": trace.seed,
                            "spec": dataclasses.asdict(trace.spec)}) + "\n")
        for r in trace.requests:
            f.write(json.dumps(dataclasses.asdict(r)) + "\n")
    return str(path)


def load_jsonl(path) -> Trace:
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("kind") != "repro.trace":
            raise ValueError(f"{path}: not a repro trace file")
        reqs = tuple(TraceRequest(**json.loads(line))
                     for line in f if line.strip())
    return Trace(name=header["name"], seed=header["seed"],
                 spec=_spec_from_dict(header["spec"]), requests=reqs)


# ---------------------------------------------------------------------------
# presets — the named workloads serve.py / benchmarks accept by name
# ---------------------------------------------------------------------------
PRESETS: dict[str, TraceSpec] = {
    # light steady traffic: sanity/smoke lanes
    "poisson-light": TraceSpec(
        name="poisson-light", duration_s=30.0,
        arrival=ArrivalSpec(kind="poisson", rate_rps=1.0)),
    # the CI smoke workload: short MMPP bursts over a calm baseline
    "bursty": TraceSpec(
        name="bursty", duration_s=60.0,
        arrival=ArrivalSpec(kind="bursty", rate_rps=1.0,
                            burst_rate_rps=8.0, calm_dwell_s=10.0,
                            burst_dwell_s=3.0)),
    "diurnal": TraceSpec(
        name="diurnal", duration_s=240.0,
        arrival=ArrivalSpec(kind="diurnal", rate_rps=2.0,
                            period_s=120.0, depth=0.9)),
    # the BENCH_trace workload: diurnal envelope × MMPP bursts, mixed
    # lengths, two priority classes — the trace every scheduling claim
    # is measured against
    "diurnal-bursty": TraceSpec(
        name="diurnal-bursty", duration_s=600.0,
        arrival=ArrivalSpec(kind="diurnal_bursty", rate_rps=1.5,
                            period_s=200.0, depth=0.8,
                            burst_rate_rps=7.0, calm_dwell_s=40.0,
                            burst_dwell_s=20.0),
        lengths=LengthSpec(prompt_median=24.0, prompt_sigma=0.7,
                           output_medians=(8.0, 64.0),
                           output_sigmas=(0.5, 0.4),
                           output_weights=(0.75, 0.25)),
        mix=MixSpec(priorities=(("interactive", 0.7), ("batch", 0.3)),
                    n_tenants=6, tenant_skew=1.2)),
}


def get_preset(name: str) -> TraceSpec:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown trace preset {name!r} "
                         f"(one of {sorted(PRESETS)})") from None


def load_or_synthesize(name_or_path: str, seed: int = 0) -> Trace:
    """The ``--trace`` flag's resolver: a preset name synthesises, an
    existing path loads JSONL."""
    if name_or_path in PRESETS:
        return synthesize(PRESETS[name_or_path], seed=seed)
    p = pathlib.Path(name_or_path)
    if p.is_file():
        return load_jsonl(p)
    raise ValueError(f"--trace {name_or_path!r}: neither a preset "
                     f"({sorted(PRESETS)}) nor an existing file")
