"""The port's video-detection testbed (``repro_torch.core.testbed``)
against the JAX package's, on the CPU.

The same frames (``make_video`` and ``VideoRequestStream`` give the
reference's bit for bit) go through JAX's own ``run_split`` and through
the port's, which is given JAX's ``PRNGKey(0)`` weights rebuilt here by
the reference child's key splits: the combined outputs agree within 1e-4
(float32). XLA's ``"SAME"`` padding at stride 2 pads 0 before and 1
after, which ``F.conv2d(padding=1)`` does not: the padding case shows
that the symmetric pad would fail. Then the harness: two containers
give one container's outputs within 1e-5, the busy core-seconds are the
per-container times times their cores and within what those cores could
run in the wall time, the power and energy arithmetic is the reference's,
a count past the cores is refused before anything is spawned, a child
that fails or stays silent makes ``run_split`` raise within its timeout
with no process left behind, and ``device="cuda"`` is refused on a host
without a card. A few frames, two cores: the file takes about half a
minute.
"""
from __future__ import annotations

import multiprocessing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import testbed as jtb  # noqa: E402
from repro.data.pipeline import VideoRequestStream as JaxStream  # noqa: E402
from repro_torch.core import testbed as tb  # noqa: E402
from repro_torch.data.pipeline import VideoRequestStream  # noqa: E402

TOL = 1e-4


def _jax_weights():
    """The reference child's detector weights: PRNGKey(0), one split a
    convolution, then one for the head (HWIO)."""
    key = jax.random.PRNGKey(0)
    convs, cin = [], jtb._FRAME_SHAPE[-1]
    for cout in jtb._CHANNELS:
        key, k1 = jax.random.split(key)
        convs.append(np.asarray(jax.random.normal(
            k1, (3, 3, cin, cout), jnp.float32) * 0.1))
        cin = cout
    key, k1 = jax.random.split(key)
    head = np.asarray(jax.random.normal(k1, (1, 1, cin, 18),
                                        jnp.float32) * 0.1)
    return convs, head


def _no_spawn(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a container was spawned")
    monkeypatch.setattr(tb, "spawn_pinned", refuse)


@pytest.mark.parametrize("n,seed", [(3, 0), (5, 7)])
def test_frames_are_the_references_bit_for_bit(n, seed):
    assert np.array_equal(tb.make_video(n, seed), jtb.make_video(n, seed))
    assert tb.make_video(n, seed).dtype == np.float32
    ours, theirs = VideoRequestStream(n, seed=seed), JaxStream(n, seed=seed)
    assert np.array_equal(ours.frames(), theirs.frames())
    assert all(np.array_equal(a, b) for a, b in zip(
        ours.prompt_requests(1000, 8), theirs.prompt_requests(1000, 8)))
    assert VideoRequestStream().n_frames == 900      # 30 s at 30 fps


def test_constants_and_weight_layout_are_the_references():
    assert (tb.P_IDLE_W, tb.P_CORE_W) == (jtb.P_IDLE_W, jtb.P_CORE_W)
    assert (tb._FRAME_SHAPE, tb._CHANNELS) == (jtb._FRAME_SHAPE,
                                               jtb._CHANNELS)
    convs, head = _jax_weights()
    ours = tb.weights_from_jax(convs, head)
    defaults = tb.detector_weights(0)
    assert [w.shape for w in ours] == [w.shape for w in defaults] == [
        (16, 3, 3, 3), (32, 16, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3),
        (256, 128, 3, 3), (18, 256, 1, 1)]
    assert np.array_equal(ours[1][5, 7], convs[1][:, :, 7, 5])
    assert all(np.array_equal(a, b) for a, b in zip(
        defaults, tb.detector_weights(0)))
    assert not np.array_equal(defaults[0], tb.detector_weights(1)[0])


def test_same_padding_is_xlas_and_a_symmetric_pad_is_not():
    """One stride-2 3x3 convolution over a 128x128 frame: the port's pad
    (0 before, 1 after) gives XLA's "SAME" result, padding=1 does not."""
    import torch.nn.functional as F

    x = tb.make_video(1, seed=3)
    w = tb.detector_weights(0)[0]                          # OIHW
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
        window_strides=(2, 2), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    assert tb._same_pad(128, 3, 2) == (0, 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = F.conv2d(F.pad(xt, (0, 1, 0, 1)), torch.from_numpy(w), stride=2)
    sym = F.conv2d(xt, torch.from_numpy(w), stride=2, padding=1)
    assert ours.shape == sym.shape == (1, 16, 64, 64)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def test_detector_matches_jax_run_split():
    """JAX's own ``run_split(frames, 1, batch=4)`` (its child draws its
    weights from PRNGKey(0)) against the port's, in process and through
    the port's ``run_split`` on the CPU, given those weights rebuilt."""
    frames = tb.make_video(6, seed=1)              # a padded tail batch
    want = jtb.run_split(frames, 1, total_cores=2, batch=4).outputs
    weights = tb.weights_from_jax(*_jax_weights())
    got = tb.run_split(frames, 1, total_cores=2, batch=4, device="cpu",
                       weights=weights)
    assert got.outputs.shape == want.shape == (6, 18)
    assert got.outputs.dtype == np.float32
    np.testing.assert_allclose(got.outputs, want, atol=TOL, rtol=TOL)
    direct = tb.detector_forward([torch.from_numpy(w) for w in weights],
                                 torch.from_numpy(frames))
    np.testing.assert_allclose(direct.numpy(), want, atol=TOL, rtol=TOL)
    # the default weights are the port's own draw, not JAX's
    own = tb.detector_forward(
        [torch.from_numpy(w) for w in tb.detector_weights(0)],
        torch.from_numpy(frames[:2]))
    assert np.abs(own.numpy() - want[:2]).max() > TOL


def test_two_containers_give_one_containers_outputs():
    frames = tb.make_video(7, seed=2)
    one = tb.run_split(frames, 1, total_cores=2, batch=4, device="cpu")
    two = tb.run_split(frames, 2, total_cores=2, batch=4, device="cpu")
    assert two.outputs.shape == one.outputs.shape == (7, 18)
    np.testing.assert_allclose(two.outputs, one.outputs, atol=1e-5,
                               rtol=0)
    assert (one.cores_per_container, two.cores_per_container) == (2, 1)
    assert two.disjoint and len(two.per_container_s) == 2
    for r, n in ((one, 1), (two, 2)):
        cpc = r.cores_per_container
        assert r.busy_core_seconds == sum(t * cpc for t in r.per_container_s)
        assert 0 < r.busy_core_seconds <= n * cpc * r.wall_s + 1e-6
        assert max(r.per_container_s) <= r.wall_s
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("times,cpc,wall", [([1.5], 4, 1.6),
                                            ([0.7, 0.9, 0.8], 2, 1.0)])
def test_power_and_energy_are_the_references(times, cpc, wall):
    busy = sum(t * cpc for t in times)
    args = (len(times), cpc, wall, times, np.zeros((1, 18)), busy)
    ours, theirs = tb.SplitRunResult(*args), jtb.SplitRunResult(*args)
    assert ours.avg_power_w == theirs.avg_power_w
    assert ours.energy_j == theirs.energy_j
    assert ours.disjoint and ours.energy_j == ours.avg_power_w * wall


def test_more_containers_than_cores_refused_before_any_spawn(monkeypatch):
    _no_spawn(monkeypatch)
    frames = tb.make_video(2)
    with pytest.raises(ValueError, match="disjoint"):
        tb.run_split(frames, len(tb.available_cores()) + 1, device="cpu")
    with pytest.raises(ValueError, match="disjoint"):
        tb.run_split(frames, 3, total_cores=2, device="cpu")


def test_failing_container_raises_naming_it_and_leaves_no_process():
    frames = tb.make_video(4)
    bad = tb.detector_weights(0)
    bad[2] = bad[2][:, :5]                 # 5 input channels where 32 come
    with pytest.raises(RuntimeError, match="container 0 failed") as e:
        tb.run_split(frames, 2, total_cores=2, batch=2, device="cpu",
                     weights=bad, timeout_s=120)
    assert "conv" in str(e.value) or "channels" in str(e.value)
    assert not multiprocessing.active_children()


def test_silent_container_times_out_and_leaves_no_process():
    with pytest.raises(TimeoutError, match="container 0: no 'ready'"):
        tb.run_split(tb.make_video(2), 1, total_cores=1, device="cpu",
                     timeout_s=0.01)
    assert not multiprocessing.active_children()


def test_cuda_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_spawn(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.run_split(tb.make_video(2), 1, total_cores=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.run_single_container(tb.make_video(2), 1)
