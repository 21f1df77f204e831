"""Independence of the sampler's streams across seeds.

The port's Gumbel noise is a counter hash of (seed, draw, element), not
JAX's threefry, so the bits differ from JAX's by design; what the two
must share is that ``PRNGKey(seed)`` streams are independent. These tests
hold the port's noise to that: no pair of seeds is correlated under any
xor shift of the element index (the relation a seed xored into the raw
counter would create), and flat logits sample no seed's tokens as
another seed's tokens xor the seed. JAX's own uniforms pass the same
correlation check on the same shapes.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.models import sampling  # noqa: E402

SEEDS = (0, 7, 8, 9, 100)
ROWS, COLS = 4, 151_936            # four rows of qwen3's vocabulary
SHIFTS = 256                       # xor shifts 0..255 of the element index
CORR_LIMIT = 0.02


def _standardised(u: np.ndarray) -> np.ndarray:
    """``u`` (float64, flat) centred and scaled to unit norm, as
    (n / SHIFTS, SHIFTS): an xor shift below 256 only permutes the
    elements inside each row of this view."""
    u = u - u.mean()
    return (u / np.linalg.norm(u)).reshape(-1, SHIFTS)


def _max_xor_corr(a: np.ndarray, b: np.ndarray) -> float:
    """max over k in 0..255 of |corr(a[e], b[e ^ k])|, from one product:
    with C = a.T @ b over the (n / 256, 256) views, the correlation at
    shift k is the sum of C[j, j ^ k] over j."""
    c = _standardised(a).T @ _standardised(b)
    j = np.arange(SHIFTS)
    return max(abs(float(c[j, j ^ k].sum())) for k in range(SHIFTS))


def _port_noise(seed: int) -> np.ndarray:
    u = sampling.uniform(sampling.new_key(seed, 0), ROWS, COLS)
    return u.numpy().astype(np.float64).reshape(-1)


def _jax_noise(seed: int) -> np.ndarray:
    u = jax.random.uniform(jax.random.PRNGKey(seed), (ROWS * COLS,))
    return np.asarray(u, np.float64)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_no_two_seeds_correlate_under_an_xor_shift(source):
    noise = {s: (_port_noise if source == "port" else _jax_noise)(s)
             for s in SEEDS}
    worst = {(a, b): _max_xor_corr(noise[a], noise[b])
             for a, b in itertools.combinations(SEEDS, 2)}
    assert max(worst.values()) < CORR_LIMIT, worst


def test_one_seed_at_two_draws_is_uncorrelated_under_an_xor_shift():
    a = sampling.uniform(sampling.new_key(7, 0), ROWS, COLS)
    b = sampling.uniform(sampling.new_key(7, 1), ROWS, COLS)
    assert _max_xor_corr(a.numpy().astype(np.float64).reshape(-1),
                         b.numpy().astype(np.float64).reshape(-1)) \
        < CORR_LIMIT


def test_flat_logits_sample_no_seed_as_seed_zero_xor_the_seed():
    logits = torch.zeros(4, 1024)
    base = sampling.gumbel_argmax(logits, sampling.new_key(0, 0))
    for seed in (7, 8, 9, 100):
        got = sampling.gumbel_argmax(logits, sampling.new_key(seed, 0))
        assert not bool((got == (base ^ seed)).any()), (seed, got, base)
        assert not torch.equal(got, base)


def test_xor_related_seeds_would_fail_the_check():
    """The check has teeth: noise built as the pre-repair hash (the seed
    xored into the raw counter) is caught at shift ``seed``."""
    e = torch.arange(ROWS * COLS, dtype=torch.int64)

    def old(seed: int) -> np.ndarray:
        x = sampling._mix(e ^ seed)
        x = sampling._mix(x ^ 0)
        return ((x >> 8).double() + 0.5).numpy() * 2.0 ** -24

    assert _max_xor_corr(old(0), old(7)) > 0.99
