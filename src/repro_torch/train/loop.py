"""The train step and loop, as ``repro.train.loop``: the loss's gradient
(``Model.loss``), optional rematerialisation and gradient accumulation
over microbatches, the global-norm clip and AdamW.

The step runs on the model's device (``Model(cfg)`` is ``"cuda"`` unless
told ``"cpu"``, and raises without a card). On the card every forward
and backward of the path runs as a hand-written kernel (the SSD scan's
through ``ssd_scan_bwd``, so the ssm and zamba families train there
too), and float32 is the only dtype with backward kernels, so
``make_train_step`` refuses bfloat16 parameters on the card. The CPU
trains every family and dtype through the plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (AdamWConfig, apply_update,
                                         init_opt_state, map_tree,
                                         unique_leaves, zip_leaves)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    remat: bool = False
    remat_policy: str = "none"   # "collectives" has no meaning on one card
    microbatches: int = 1        # grad accumulation factor


def check_card_training(model: Model, params=None) -> None:
    """Refuse, naming the missing kernels, what the card cannot train:
    bfloat16 parameters (``flash_attention_bwd``, ``rmsnorm_bwd`` and
    ``ssd_scan_bwd`` exist in float32 only). Every family trains there in
    float32, the ssm and zamba families through ``ssd_scan_bwd``, whose
    state width (``ssd_scan.BWD_MAX_STATE``) every registry config fits;
    a wider one is refused here, never inside a step."""
    if model.device.type != "cuda":
        return
    if model.fam in ("ssm", "zamba") and \
            model.cfg.ssm_state > _ssd.BWD_MAX_STATE:
        raise NotImplementedError(
            f"{model.cfg.name}: no train step on the card for ssm_state="
            f"{model.cfg.ssm_state}: ssd_scan_bwd takes ds up to "
            f"{_ssd.BWD_MAX_STATE} (train it with device='cpu')")
    dtypes = {t.dtype for t in unique_leaves(params or {})}
    if torch.bfloat16 in dtypes:
        raise NotImplementedError(
            f"{model.cfg.name}: no train step on the card for bfloat16 "
            "parameters: flash_attention_bwd, rmsnorm_bwd and ssd_scan_bwd "
            "exist in float32 only")


def loss_and_grads(model: Model, params, batch, remat: bool = False):
    """``Model.loss`` of ``batch`` and its gradient with respect to every
    distinct tensor of ``params``. The gradient is taken on detached
    views that require grad, so the caller's tensors keep
    ``requires_grad`` off and a later serving call on them keeps its
    inference path. Returns ``(loss, metrics, grads)``, grads keyed by
    the ``id`` of each tensor of ``params``."""
    views = map_tree(lambda t: t.detach().requires_grad_(True), params)
    pairs = zip_leaves(params, views)
    loss, metrics = model.loss(views, batch, remat=remat)
    grads = torch.autograd.grad(loss, [v for _, v in pairs])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        {id(p): g for (p, _), g in zip(pairs, grads)}


def make_train_step(model: Model, tcfg: TrainConfig,
                    params=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, which updates ``params`` and the moments in
    place. ``batch`` holds numpy arrays or tensors (``tokens`` (B, S),
    optional ``loss_mask``, ``vision_embeds``, ``audio_frames``). With
    ``microbatches`` > 1 the batch splits along its first axis and the
    float32 gradients of the pieces are added and divided by their count,
    as JAX's scan does. Refuses here, never inside a step, a family or
    dtype (``params``, where given) the card cannot train, and a
    ``remat_policy`` other than ``"none"``."""
    if tcfg.remat_policy != "none":
        raise ValueError(
            f"remat_policy={tcfg.remat_policy!r}: only 'none' on one card "
            "('collectives' saves the all-reduce outputs of a mesh)")
    if tcfg.microbatches < 1:
        raise ValueError(f"microbatches={tcfg.microbatches} < 1")
    check_card_training(model, params)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        n = tcfg.microbatches
        if n > 1:
            micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(n)]
            acc, loss_sum = {}, 0.0
            for mb in micro:
                loss, _, grads = loss_and_grads(model, params, mb,
                                                tcfg.remat)
                for key, g in grads.items():
                    acc[key] = acc[key] + g.float() if key in acc \
                        else g.float()
                loss_sum = loss_sum + loss
            grads = {key: g / n for key, g in acc.items()}
            loss, metrics = loss_sum / n, {}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  tcfg.remat)
        tree = map_tree(lambda p: grads[id(p)], params)
        params, opt_state, opt_metrics = apply_update(tcfg.opt, params, tree,
                                                      opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def train(model: Model, tcfg: TrainConfig, batches, n_steps: int,
          params=None, seed: int = 0, log_every: int = 10,
          logger: Callable[[int, dict], None] | None = None):
    """The training loop on the model's device (examples, tests): from
    ``params`` (default ``model.init(seed)``), ``n_steps`` steps over
    ``batches``. Returns ``(params, opt_state, history)``, history a
    dict of the scalar metrics every ``log_every`` steps and at the
    last."""
    params = params if params is not None else model.init(seed)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, tcfg, params)
    history = []
    t0 = time.time()
    for step, batch in enumerate(batches):
        if step >= n_steps:
            break
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()
                 if not isinstance(v, torch.Tensor) or v.dim() == 0}
            m["step"] = step
            m["wall_s"] = time.time() - t0
            history.append(m)
            if logger:
                logger(step, m)
    return params, opt_state, history
