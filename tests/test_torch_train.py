"""Training on the port against the JAX package, on the CPU.

``Model.forward`` / ``Model.loss`` of one reduced config of each of the
seven families against JAX's (logits within 1e-4, loss within 1e-5
relative), with a ``loss_mask`` and MoE's Switch aux loss at the training
capacity; gradients against ``jax.value_and_grad(Model.loss)`` leaf by
leaf through ``params.to_numpy`` (5e-5 of max|leaf|); AdamW's update and
schedule against JAX's; microbatching, rematerialisation, 60 steps of
falling loss, 3 steps of ``train`` against JAX's ``train``;
``LmTokenStream`` bit for bit; checkpoints in JAX's format both ways; the
launcher; what the card trains and refuses. JAX runs on the CPU as its own
tests run it (jitted), and its results are computed once per module. Inputs come from a
seeded numpy generator and weights from JAX's init through
``params.from_numpy``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.data.pipeline import LmTokenStream as JaxStream  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data.pipeline import LmTokenStream  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

FAMILIES = {"dense": "qwen3-0.6b-reduced", "gemma": "gemma3-27b-reduced",
            "moe": "deepseek-v2-lite-16b-reduced",
            "ssm": "mamba2-2.7b-reduced", "zamba": "zamba2-7b-reduced",
            "whisper": "whisper-large-v3-reduced",
            "vision": "internvl2-26b-reduced"}
GRAD_FAMILIES = ("dense", "moe", "gemma", "whisper", "ssm", "zamba")
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are small: one torch thread runs them about as
    fast as many, and keeps the module from oversubscribing the cores
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name: str):
    jc = jax_config(name)
    if jc.is_moe:
        jc = dataclasses.replace(jc, router_aux_loss_coef=0.003)
    return jc, ArchConfig(**dataclasses.asdict(jc))


def _batch(cfg, seed: int = 0, mask: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.int32)
    if cfg.n_vision_tokens:
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_embed_dim)).astype(np.float32)
    if cfg.arch_type == "audio":
        b["audio_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_tree_close(got: dict, want: dict, tol: float) -> None:
    """Every leaf of ``want`` within tol · max|leaf| of ``got``'s."""
    for path, a in _leaves(want):
        b = _at(got, path)
        assert b.shape == a.shape, path
        bound = tol * max(float(np.max(np.abs(a))), 1e-30)
        err = float(np.max(np.abs(a - b)))
        assert err <= bound, (path, err, bound)


@pytest.fixture(scope="module")
def jax_runs():
    """Per family: JAX's init as numpy, the batch, and JAX's train-mode
    logits, loss, metrics and (for GRAD_FAMILIES) gradients."""
    runs = {}
    for fam, name in FAMILIES.items():
        jc, cfg = _configs(name)
        jm = JaxModel(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _batch(cfg, mask=fam in ("dense", "vision"))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss_fn = (jax.value_and_grad(jm.loss, has_aux=True)
                   if fam in GRAD_FAMILIES else jm.loss)
        (logits, aux), out = jax.jit(lambda p, b: (
            jm.forward(p, b, train=True), loss_fn(p, b)))(jp, jb)
        run = {"cfg": cfg, "tree": _np(jp), "batch": batch,
               "logits": np.asarray(logits), "aux": float(aux)}
        if fam in GRAD_FAMILIES:
            (loss, met), grads = out
            run["grads"] = _np(grads)
        else:
            loss, met = out
        run["loss"], run["metrics"] = float(loss), _np(met)
        runs[fam] = run
    return runs


def _port(run):
    cfg = run["cfg"]
    return Model(cfg, device="cpu"), bridge.from_numpy(cfg, run["tree"],
                                                       device="cpu")


def test_lm_token_stream_is_jax_bit_for_bit():
    for seed, (V, S_, Bb) in enumerate([(512, 32, 4), (151_936, 64, 2),
                                        (100, 33, 3)]):
        mine, ref = LmTokenStream(V, S_, Bb, seed), JaxStream(V, S_, Bb, seed)
        for step in (0, 1, 17):
            a, b = mine.batch(step)["tokens"], ref.batch(step)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b)
        gen = mine.batches(start=5)
        assert np.array_equal(next(gen)["tokens"], ref.batch(5)["tokens"])


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_forward_and_loss_match_jax(jax_runs, fam):
    run = jax_runs[fam]
    model, params = _port(run)
    with torch.no_grad():
        logits, aux = model.forward(params, run["batch"], train=True)
        loss, met = model.loss(params, run["batch"])
    np.testing.assert_allclose(logits.numpy(), run["logits"], atol=1e-4,
                               rtol=1e-4)
    assert float(loss) == pytest.approx(run["loss"], rel=1e-5)
    assert float(met["nll"]) == pytest.approx(float(run["metrics"]["nll"]),
                                              rel=1e-5)
    assert float(met["tokens"]) == float(run["metrics"]["tokens"])
    assert float(met["moe_aux"]) == pytest.approx(run["aux"], rel=1e-5,
                                                  abs=1e-7)
    if fam == "moe":
        assert run["aux"] > 0
    if fam == "vision":   # the image's positions carry logits, no loss
        assert logits.shape[1] == S + run["cfg"].n_vision_tokens


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_to_numpy_inverts_from_numpy_bit_for_bit(jax_runs, fam):
    run = jax_runs[fam]
    back = bridge.to_numpy(run["cfg"], bridge.from_numpy(
        run["cfg"], run["tree"], device="cpu"))
    assert len(list(_leaves(back))) == len(list(_leaves(run["tree"])))
    for path, a in _leaves(run["tree"]):
        b = _at(back, path)
        assert b.dtype == a.dtype and np.array_equal(a, b), path


def _grads(model, params, batch, **kw):
    leaves = opt.unique_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch, **kw)
    g = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), opt.map_tree(lambda p: g[id(p)], params)


@pytest.mark.parametrize("fam", GRAD_FAMILIES)
def test_grads_match_jax(jax_runs, fam):
    run = jax_runs[fam]
    model, params = _port(run)
    loss, grads = _grads(model, params, run["batch"])
    assert float(loss) == pytest.approx(run["loss"], rel=1e-5)
    _assert_tree_close(bridge.to_numpy(run["cfg"], grads), run["grads"], 5e-5)


@pytest.mark.parametrize("fam", ["dense", "gemma", "moe", "zamba"])
def test_remat_gives_the_same_loss_and_grads(jax_runs, fam):
    run = jax_runs[fam]
    model, params = _port(run)
    l0, g0 = _grads(model, params, run["batch"])
    l1, g1 = _grads(model, params, run["batch"], remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(opt.unique_leaves(g0), opt.unique_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_policy_collectives_has_no_meaning_on_one_card(jax_runs):
    model, params = _port(jax_runs["dense"])
    with pytest.raises(ValueError, match="collectives"):
        model.loss(params, jax_runs["dense"]["batch"], remat=True,
                   remat_policy="collectives")
    with pytest.raises(ValueError, match="collectives"):
        loop.make_train_step(model, loop.TrainConfig(
            remat_policy="collectives"))


def test_schedule_matches_jax():
    for cfg in (opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110),
                opt.AdamWConfig(lr=3e-4),
                opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=7)):
        jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 5, 10, 11, 60, 110, 200):
            want = float(jax_opt.schedule(jcfg, jnp.asarray(step)))
            assert opt.schedule(cfg, step) == pytest.approx(want, rel=1e-6,
                                                            abs=1e-12)


def test_apply_update_matches_jax():
    """Two steps over a tree of 1-d and 2-d leaves (decay on the 2-d only),
    the first with the clip biting."""
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal(6).astype(np.float32),
            "n": {"scale": rng.standard_normal(5).astype(np.float32),
                  "m": rng.standard_normal((3, 4, 5)).astype(np.float32)}}
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jst = jax.tree.map(jnp.asarray, tree), jax_opt.init_opt_state(tree)
    params = {k: (torch.from_numpy(v.copy()) if not isinstance(v, dict)
                  else {kk: torch.from_numpy(vv.copy())
                        for kk, vv in v.items()}) for k, v in tree.items()}
    state = opt.init_opt_state(params)
    for scale in (30.0, 0.1):
        g = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape))
                         .astype(np.float32), tree)
        jp, jst, jm = jax_opt.apply_update(jcfg, jp, g, jst)
        params, state, m = opt.apply_update(
            cfg, params, jax.tree.map(torch.from_numpy, g), state)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        for name, mine, ref in (("params", params, jp),
                                ("m", state["m"], jst["m"]),
                                ("v", state["v"], jst["v"])):
            for path, a in _leaves(_np(ref)):
                np.testing.assert_allclose(_at(mine, path).numpy(), a,
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {path}")
    assert state["step"] == int(jst["step"]) == 2


def test_microbatches_two_equal_one():
    """JAX's test_microbatched_grads_match_full_batch on the port: one
    step over 4 rows as one batch and as 2 microbatches."""
    cfg = ArchConfig(**dataclasses.asdict(jax_config("stablelm-1.6b-reduced")))
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16))}
    out = []
    for n in (1, 2):
        params = model.init(seed=0)
        step = loop.make_train_step(model, loop.TrainConfig(microbatches=n))
        p, _, m = step(params, opt.init_opt_state(params), batch)
        out.append((p, m))
    for a, b in zip(opt.unique_leaves(out[0][0]), opt.unique_leaves(out[1][0])):
        assert float((a - b).detach().abs().max()) < 2e-5
    assert float(out[1][1]["loss"]) == pytest.approx(
        float(out[0][1]["loss"]), rel=1e-5)


def test_train_step_leaves_the_parameters_out_of_autograd():
    """A train step takes its gradients on detached views: it moves every
    parameter, the caller's tensors keep ``requires_grad`` off, and a
    later forward on them under grad mode records no graph (the kernels'
    inference path, which serving takes)."""
    cfg = ArchConfig(**dataclasses.asdict(jax_config("qwen3-0.6b-reduced")))
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    before = [t.clone() for t in opt.unique_leaves(params)]
    step = loop.make_train_step(model, loop.TrainConfig(
        opt=opt.AdamWConfig(lr=1e-3, warmup_steps=1)))
    params, _, _ = step(params, opt.init_opt_state(params), _batch(cfg))
    leaves = opt.unique_leaves(params)
    assert not any(t.requires_grad for t in leaves)
    assert not any(torch.equal(a, b) for a, b in zip(leaves, before))
    assert torch.is_grad_enabled()
    assert not model.forward(params, _batch(cfg, 1))[0].requires_grad


def test_loss_decreases_over_short_run():
    """JAX's test_loss_decreases_over_short_run on the port."""
    cfg = ArchConfig(**dataclasses.asdict(jax_config("qwen3-0.6b-reduced")))
    model = Model(cfg, device="cpu")
    stream = LmTokenStream(cfg.vocab_size, seq_len=32, batch_size=8)
    tcfg = loop.TrainConfig(opt=opt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=60))
    _, _, hist = loop.train(model, tcfg, stream.batches(), n_steps=60,
                            log_every=59)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first * 0.8, (first, last)


def test_three_steps_of_train_match_jax():
    """``train`` from JAX's init over JAX's stream, 3 steps, with the
    default TrainConfig (JAX's ``train`` default): every parameter within
    1e-4 of max|leaf| of JAX's, the losses within 1e-5."""
    jc, cfg = _configs("qwen3-0.6b-reduced")
    jm = JaxModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = _np(jp)
    jp3, _, jh = jax_loop.train(jm, jax_loop.TrainConfig(),
                                JaxStream(jc.vocab_size, 32, 4).batches(),
                                n_steps=3, params=jp, log_every=1)
    model = Model(cfg, device="cpu")
    p3, st, h = loop.train(model, loop.TrainConfig(),
                           LmTokenStream(cfg.vocab_size, 32, 4).batches(),
                           n_steps=3, params=bridge.from_numpy(
                               cfg, tree, device="cpu"), log_every=1)
    assert st["step"] == 3 and len(h) == 3
    for a, b in zip(h, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    _assert_tree_close(bridge.to_numpy(cfg, p3), _np(jp3), 1e-4)


def test_checkpoint_round_trip_in_jax_format(tmp_path):
    cfg = ArchConfig(**dataclasses.asdict(jax_config("zamba2-7b-reduced")))
    model = Model(cfg, device="cpu")
    params = model.init(seed=3)
    state = opt.init_opt_state(params)
    state["step"] = 5
    for t in opt.unique_leaves(state["m"]):
        t.normal_()
    path = os.path.join(tmp_path, "ck")
    checkpoint.save(path, checkpoint.state_to_numpy(cfg, params, state),
                    meta={"step": 17})
    assert checkpoint.load_meta(path)["step"] == 17
    like = checkpoint.state_to_numpy(cfg, model.init(seed=4),
                                     opt.init_opt_state(params))
    p2, s2 = checkpoint.state_from_numpy(cfg, checkpoint.restore(path, like),
                                         device="cpu")
    for a, b in zip(opt.unique_leaves(params), opt.unique_leaves(p2)):
        assert torch.equal(a, b)
    for a, b in zip(opt.unique_leaves(state["m"]), opt.unique_leaves(s2["m"])):
        assert torch.equal(a, b)
    assert s2["step"] == 5
    # zamba's shared block stays one dict at every application
    assert len(opt.unique_leaves(p2)) == len(opt.unique_leaves(params))
    # the same file through JAX's restore, and JAX's file through ours
    jtree = jax_ckpt.restore(path, jax.tree.map(jnp.zeros_like, like))
    assert np.array_equal(np.asarray(jtree["params"]["embed"]["table"]),
                          params["embed"]["table"].numpy())
    jax_ckpt.save(os.path.join(tmp_path, "jx"), like["params"])
    back = checkpoint.restore(os.path.join(tmp_path, "jx"),
                              bridge.to_numpy(cfg, params))
    _assert_tree_close(back, like["params"], 0.0)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    path = os.path.join(tmp_path, "ck2")
    checkpoint.save(path, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, {"w": torch.ones(3, 3)})
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(path, {"v": torch.ones(2, 2)})
    got = checkpoint.restore(path, {"w": torch.zeros(2, 2,
                                                     dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and bool((got["w"] == 1).all())


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch
    path = os.path.join(tmp_path, "run")
    report = launch.main(["--reduced", "--device", "cpu", "--steps", "3",
                          "--seq", "32", "--save", path])
    out = capsys.readouterr().out
    assert "arch=qwen3-0.6b-reduced" in out and "kernel launches" in out
    assert len(report["loss"]) == 3 and all(np.isfinite(report["loss"]))
    assert report["peak_bytes"] is None
    assert checkpoint.load_meta(path)["steps"] == 3


def test_card_refuses_what_it_cannot_train():
    """On the card, make_train_step accepts the SSM and hybrid families in
    float32 (their scan trains through ssd_scan_bwd), refuses a state
    wider than that kernel takes and bfloat16 parameters (float32
    backward kernels only), naming what is missing; the CPU trains
    them."""
    for name in ("mamba2-2.7b-reduced", "zamba2-7b-reduced"):
        cfg = ArchConfig(**dataclasses.asdict(jax_config(name)))
        model = Model(cfg, device="cpu")
        params = model.init(seed=0)
        bf16 = model.init(seed=0, dtype=torch.bfloat16)
        loop.make_train_step(model, loop.TrainConfig(), params)
        model.device = torch.device("cuda", 0)
        loop.make_train_step(model, loop.TrainConfig(), params)
        with pytest.raises(NotImplementedError, match="bfloat16"):
            loop.make_train_step(model, loop.TrainConfig(), bf16)
        wide = Model(dataclasses.replace(cfg, ssm_state=256), device="cpu")
        wide.device = torch.device("cuda", 0)
        with pytest.raises(NotImplementedError, match="ssd_scan_bwd"):
            loop.make_train_step(wide, loop.TrainConfig())
    cfg = ArchConfig(**dataclasses.asdict(jax_config("qwen3-0.6b-reduced")))
    model = Model(cfg, device="cpu")
    params = model.init(seed=0, dtype=torch.bfloat16)
    step = loop.make_train_step(model, loop.TrainConfig(), params)
    step(params, opt.init_opt_state(params),
         {"tokens": np.zeros((2, 8), np.int32)})
    model.device = torch.device("cuda", 0)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        loop.make_train_step(model, loop.TrainConfig(), params)
