"""Model assembly for the dense (with a vision prefix), gemma, MoE, SSM,
hybrid (zamba) and audio encoder-decoder (whisper) families: init,
caches, prefill, decode.

A port of ``repro.models.model.Model``, every family, with its training
forward and loss (``forward``, ``loss``). JAX scans one
stacked parameter tree over the layers (for moe, the ``n_dense_layers``
leading dense layers as ``dense0``, then the MoE ``stack``; for gemma,
``super`` blocks of ``local_global_pattern`` local layers and one
global, then the ``rem`` local layers; for zamba, ``super`` blocks of
``shared_attn_every`` SSM layers each followed by the one weight-shared
attention + MLP block, then the ``rem`` SSM layers); the port keeps one
parameter dict per layer (``params["layers"]``, in that order: for gemma
each super-block's locals, its global, then the remainder; for zamba
each super-block's SSM layers, then the shared block's one dict, the
same object at every application, then the remainder) and loops over
them, each layer with its window (``Model.windows``: ``sliding_window``
for a local layer, 0 for a global one or an application of zamba's
shared block) and its kind (``Model.kinds``: ``"ssm"`` or ``"attn"``).

A model with ``n_vision_tokens`` (internvl2) takes each prompt's
precomputed patch embeddings, ``vision_embeds`` (B, nv, vision_embed_dim)
float32, at prefill: ``vis_proj`` maps them (``w1``, the tanh gelu,
``w2``) into the embedding space ahead of the token embeddings, so the
image holds positions 0 .. nv - 1 and the prompt starts at nv.

Whisper takes each prompt's precomputed frame embeddings,
``audio_frames`` (B, encoder_seq, d) float32, at prefill: the encoder
(``enc_layers``, each ``attn_mlp`` with a plain gelu MLP, not causal,
then ``enc_norm``) runs in the frames' dtype (float32 against bfloat16
weights, as JAX promotes), from the frames plus the fixed sinusoid of
``layers.sinusoid``; each decoder layer (``cross_prefill``) projects the
output into its cross-attention keys and values, which that prefill
reads in float32 and its cache stores in the cache's dtype. The token
embeddings get the same sinusoid at their positions, at prefill over
``0 .. S - 1`` and at decode over ``pos``. ``config.pos_embed`` reads
"learned", as JAX's does; like JAX, the port learns no position table.

The fused chunk has one body, ``decode_chunk_step``: one ``decode_step``,
the pick (argmax, or with ``greedy=False`` a Gumbel-max sample from the
random stream ``key`` held in the same buffers, ``models/sampling.py``)
and the per-slot bookkeeping (tokens, positions, remaining budgets,
active flags, emitted counts, the token block), all updated in place in
device tensors (``chunk_buffers``) with no host read.
``decode_chunk`` loops it ``n_tokens`` times, as JAX's ``lax.scan`` runs
its step body; on the card the serving engine captures the same body
once in a CUDA graph and replays it (``serving/engine.py``).

Parameters::

    {"embed": {"table": (V, d)}, "final_norm": {...},
     "lm_head": {"w": (d, V)}  (untied configs only),
     "vis_proj": {"w1": {"w": (vd, d)}, "w2": {"w": (d, d)}}  (vision),
     "layers": [{"ln1", "attn", "ln2", "mlp"} per layer]   (dense, gemma)
               [{"ln1", "self_attn", "ln2", "cross_attn", "ln3",
                 "mlp"} per decoder layer]                  (whisper)
               [{"ln1", "attn", "ln2", "mlp"} x n_dense_layers,
                {"ln1", "attn", "ln2", "moe"} x the rest]  (moe)
               [{"ln", "mamba"} per layer]                 (ssm)
               [({"ln", "mamba"} x k, shared) x n_super,
                {"ln", "mamba"} x n_rem]                   (zamba),
     "enc_layers": [{"ln1", "attn", "ln2", "mlp"} per encoder layer],
     "enc_norm": {...}                                      (whisper)}

where ``attn`` is GQA or, for a config with ``mla``, DeepSeek's latent
attention (``models/attention.py``).

Training: ``forward`` runs a batch with no cache through the cacheless
blocks (``blocks.*_fwd``) in JAX's order and returns the logits over
every position and the summed MoE aux loss; ``loss`` is JAX's next-token
loss over them. With ``remat`` each unit JAX rematerialises (a layer; a
super-block for gemma and zamba; not gemma's and zamba's remainder
layers, a MoE model's leading dense layers or whisper's encoder, which
JAX keeps) runs under ``torch.utils.checkpoint``, its activations
recomputed in the backward.

Cache: one ``{"k", "v"}`` dict of (B, W, Hkv, hd) tensors per layer (a
ring ``W = min(window, max_len)`` wide), or, with a ``PagedLayout``, one
paged group per full-horizon layer over a block table that every layer
shares (``models/cache.py``), a sliding ring staying dense rows; with
``kv_cache_dtype="int8"`` either holds int8 codes plus float32 scales
(``models/attention.py``). An MLA layer's cache holds its latents,
``{"ckv", "k_rope"}`` rows or ``{"ckv_pages", "k_rope_pages"}`` over the
table. An SSM layer's cache is one ``{"conv", "state"}`` row group
(``models/ssm.py``), which has no paged form: a paged engine keeps
these dense rows beside its block accounting (and, for zamba, beside
the paged groups of the shared block's applications, one cache each).
A whisper layer's cache nests its self attention's group (a ring or
pages, as above) under ``"self"`` beside its memory rows ``"mem_k"`` /
``"mem_v"`` (B, encoder_seq, Hkv, hd), which stay dense under a layout,
as in JAX. Updated in place by ``prefill``, ``prefill_suffix`` and
``decode_step``.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import check_kernel_shape
from repro_torch.models import blocks
from repro_torch.models import cache as paged
from repro_torch.models import sampling
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ACTIVATIONS, embed_fwd, gelu_tanh,
                                       init_norm, linear_fwd, norm_fwd,
                                       prefill_products, project, sinusoid,
                                       truncated_normal)

Params = dict
Cache = list


def family(cfg: ArchConfig) -> str:
    """The family of ``repro.models.model.family``."""
    if cfg.arch_type == "audio":
        return "whisper"
    if cfg.arch_type == "hybrid":
        return "zamba"
    if cfg.arch_type == "ssm":
        return "ssm"
    if cfg.is_moe:
        return "moe"
    if cfg.local_global_pattern:
        return "gemma"
    return "dense"  # incl. vlm (vision prefix handled at embed time)


def check_supported(cfg: ArchConfig) -> None:
    """The port serves every family of the JAX package: the dense family
    (text only or with a vision prefix), the gemma family (local/global
    super-blocks), the MoE family with GQA or MLA attention, the SSM
    family (mamba2), the hybrid family (zamba2: SSM layers and a
    weight-shared attention block) and the audio encoder-decoder
    (whisper), with or without a sliding window, in the model's dtype or
    over an int8 cache, with a gated SiLU or gelu MLP, and for whisper its
    sinusoidal positions and plain gelu MLP."""
    audio = cfg.arch_type == "audio"
    unsupported = {  # an MLA cache ignores kv_cache_dtype, as in JAX
        "arch_type": cfg.arch_type not in ("dense", "moe", "ssm", "hybrid",
                                           "vlm", "audio"),
        "kv_cache_dtype": cfg.kv_cache_dtype not in ("model", "int8"),
        "pos_embed": cfg.pos_embed != ("learned" if audio else "rope"),
        "act": cfg.act not in ACTIVATIONS,
        "mlp_gated": not (cfg.mlp_gated or audio),
        "encoder": audio and (cfg.n_encoder_layers < 1
                              or cfg.encoder_seq < 1),
        "shared_attn_every": (cfg.arch_type == "hybrid"
                              and cfg.shared_attn_every < 1),
        "vision_embed_dim": (cfg.n_vision_tokens > 0
                             and cfg.vision_embed_dim < 1),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(bad)})")


_PREFILL = {"mlp": blocks.attn_mlp_prefill, "moe": blocks.attn_moe_prefill,
            "ssm": blocks.ssm_prefill}
_SUFFIX_PREFILL = {"mlp": blocks.attn_mlp_suffix_prefill,
                   "moe": blocks.attn_moe_suffix_prefill}
_DECODE = {"mlp": blocks.attn_mlp_decode, "moe": blocks.attn_moe_decode,
           "ssm": blocks.ssm_decode}


def _kind(p: dict) -> str:
    """The block a layer's parameters make: ssm, moe or mlp."""
    return "ssm" if "mamba" in p else "moe" if "moe" in p else "mlp"


def check_card_shape(cfg: ArchConfig) -> None:
    """On the card, refuse a GQA model whose head shape its decode
    kernels are not instantiated for (``G = H / Hkv`` and ``K``; over an
    int8 cache, the int8 split body's shapes), before any weight or cache
    is made."""
    if cfg.arch_type == "ssm" or cfg.mla:
        return
    check_kernel_shape(cfg.name, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       int8=cfg.kv_cache_dtype == "int8")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of each entry of ``params["layers"]``: ``"ssm"`` (a
    Mamba2 block) or ``"attn"`` (an attention block: dense, MoE, an
    application of zamba's shared block, or whisper's decoder layer).
    Zamba runs ``n_layers // shared_attn_every`` super-blocks of
    ``shared_attn_every`` SSM layers and one application of the shared
    block, then the SSM layers left over, as ``repro.models.model.Model``
    lays them out."""
    fam = family(cfg)
    if fam == "ssm":
        return ["ssm"] * cfg.n_layers
    if fam == "zamba":
        per = cfg.shared_attn_every
        n_super = cfg.n_layers // per
        return (["ssm"] * per + ["attn"]) * n_super + ["ssm"] * (
            cfg.n_layers - n_super * per)
    return ["attn"] * cfg.n_layers


class Model:
    """A dense (optionally vision-prefixed), gemma, MoE, SSM or hybrid
    decoder, or whisper's encoder-decoder, on one device (``"cuda"``
    unless told ``"cpu"``)."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_card_shape(cfg)
        check_supported(cfg)
        self.cfg = cfg
        self.fam = family(cfg)
        # each entry's kind and attention window, in params["layers"]
        # order (zamba's shared block attends over the full horizon)
        self.kinds = layer_kinds(cfg)
        self.windows = (cfg.layer_windows() if self.fam != "zamba"
                        else [0] * len(self.kinds))

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32
             ) -> Params:
        """Seeded random parameters (the port's own init: same shapes and
        distributions as ``repro.models.Model.init``, other numbers)."""
        cfg = self.cfg
        g = torch.Generator(device=self.device).manual_seed(seed)
        p: Params = {
            # 0.02 scale keeps tied-head logits O(1) at init
            "embed": {"table": truncated_normal(
                (cfg.vocab_size, cfg.d_model), dtype, 0.02, g)},
            "final_norm": init_norm(cfg, cfg.d_model, dtype, self.device)}
        if not cfg.tie_embeddings:
            p["lm_head"] = {"w": truncated_normal(
                (cfg.d_model, cfg.vocab_size), dtype, cfg.d_model ** -0.5,
                g)}
        if cfg.n_vision_tokens:
            vd, d = cfg.vision_embed_dim, cfg.d_model
            p["vis_proj"] = {
                "w1": {"w": truncated_normal((vd, d), dtype, vd ** -0.5, g)},
                "w2": {"w": truncated_normal((d, d), dtype, d ** -0.5, g)}}
        if self.fam == "ssm":
            p["layers"] = [blocks.init_ssm_block(cfg, dtype, g)
                           for _ in range(cfg.n_layers)]
        elif self.fam == "zamba":
            shared = blocks.init_attn_mlp(cfg, dtype, g)
            p["layers"] = [blocks.init_ssm_block(cfg, dtype, g)
                           if k == "ssm" else shared for k in self.kinds]
        elif self.fam == "whisper":
            p["enc_layers"] = [blocks.init_attn_mlp(cfg, dtype, g)
                               for _ in range(cfg.n_encoder_layers)]
            p["enc_norm"] = init_norm(cfg, cfg.d_model, dtype, self.device)
            p["layers"] = [blocks.init_cross_block(cfg, dtype, g)
                           for _ in range(cfg.n_layers)]
        else:
            n_dense = self.n_dense_layers
            p["layers"] = [
                (blocks.init_attn_mlp if i < n_dense
                 else blocks.init_attn_moe)(cfg, dtype, g)
                for i in range(cfg.n_layers)]
        return p

    @property
    def n_dense_layers(self) -> int:
        """Leading layers with a dense MLP: all of a dense or gemma
        model's, the first ``n_dense_layers`` of an MoE model's."""
        return (self.cfg.n_dense_layers if self.fam == "moe"
                else self.cfg.n_layers)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32,
                   layout: paged.PagedLayout | None = None, *,
                   width: int | None = None) -> Cache:
        """Dense rows (each layer's ring ``min(window, max_len)`` wide),
        or with ``layout`` the paged cache: every full-horizon layer's
        group refers to one shared (batch, nblk) table, and a sliding
        ring stays dense rows, as in JAX. ``width`` makes a prefill
        mini-cache for an engine of horizon ``max_len``: its full-horizon
        groups ``width`` wide, each sliding ring as wide as the engine's,
        so the engine copies the ring whole. An int8 cache
        (``cfg.kv_cache_dtype``) ignores ``dtype`` for its codes and
        scales. An SSM layer's rows are its conv tails and states, which
        ``max_len`` does not size and no layout pages: with a layout it
        gets the same dense rows, ``batch`` of them, beside the paged
        groups of zamba's shared-block applications; a mamba2 model's
        paged engine keeps its block accounting over a tree with no paged
        group, as in JAX. A whisper layer's group is
        ``blocks.init_cross_cache``'s: its self attention's group (paged
        or ``width`` wide as any full-horizon group) beside its memory
        rows, ``batch`` of them under either cache."""
        cfg = self.cfg
        full = [k == "attn" and paged.pageable(w, max_len)
                for k, w in zip(self.kinds, self.windows)]
        table = (paged.new_table(batch, max_len, layout, self.device)
                 if layout is not None and any(full) else None)
        if self.fam == "whisper":
            return [blocks.init_cross_cache(
                cfg, batch, max_len if width is None else width, dtype,
                self.device, table=table, layout=layout)
                for _ in range(cfg.n_layers)]
        return [ssm_lib.init_mamba2_cache(cfg, batch, dtype, self.device)
                if k == "ssm" else blocks.init_block_cache(
                    cfg, batch, max_len if width is None or not f else width,
                    dtype, self.device, window=w, table=table, layout=layout)
                for k, w, f in zip(self.kinds, self.windows, full)]

    # ------------------------------------------------------------------
    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = norm_fwd(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return project(x, params["embed"]["table"].T)
        return linear_fwd(params["lm_head"], x)

    @staticmethod
    def _sel(x: torch.Tensor, logits_at) -> torch.Tensor:
        """Hidden state the head runs on: one shared position (int) or one
        per sequence ((B,) tensor — bucket-batched ragged prompts)."""
        if isinstance(logits_at, int):
            return x[:, logits_at]
        idx = torch.as_tensor(logits_at, dtype=torch.long, device=x.device)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def _embed(self, params: Params, tokens: torch.Tensor,
               vision_embeds: torch.Tensor | None) -> torch.Tensor:
        """The token embeddings, behind the projected image for a model
        with ``n_vision_tokens``: ``vision_embeds`` (B, nv, vd) through
        ``vis_proj`` in its own dtype (float32, as JAX promotes it against
        the weights), the tanh gelu between, cast to the embeddings'
        dtype. Whisper's get the sinusoid of positions 0 .. S - 1."""
        x = embed_fwd(params["embed"], tokens)
        if self.fam == "whisper":
            pos = torch.arange(x.shape[1], device=x.device)
            return x + sinusoid(pos, self.cfg.d_model).to(x.dtype)
        nv = self.cfg.n_vision_tokens
        if not nv:
            return x
        shape = (tokens.shape[0], nv, self.cfg.vision_embed_dim)
        if vision_embeds is None or tuple(vision_embeds.shape) != shape:
            got = None if vision_embeds is None else tuple(
                vision_embeds.shape)
            raise ValueError(f"{self.cfg.name}: prefill needs vision_embeds "
                             f"of shape {shape}, got {got}")
        vp = params["vis_proj"]
        v = vision_embeds.to(x.device)
        v = project(v, vp["w1"]["w"])
        v = project(gelu_tanh(v), vp["w2"]["w"])
        return torch.cat([v.to(x.dtype), x], dim=1)

    def _encode(self, params: Params, frames: torch.Tensor | None,
                batch: int) -> torch.Tensor:
        """Whisper's encoder over ``frames`` (B, encoder_seq, d) in their
        dtype: frames plus the sinusoid, the encoder layers, ``enc_norm``
        (JAX's ``_encode``)."""
        cfg = self.cfg
        shape = (batch, cfg.encoder_seq, cfg.d_model)
        if frames is None or tuple(frames.shape) != shape:
            got = None if frames is None else tuple(frames.shape)
            raise ValueError(f"{cfg.name}: prefill needs audio_frames of "
                             f"shape {shape}, got {got}")
        x = frames.to(self.device)
        pos = torch.arange(cfg.encoder_seq, device=x.device)
        x = x + sinusoid(pos, cfg.d_model).to(x.dtype)
        for p in params["enc_layers"]:
            x = blocks.encoder_fwd(p, cfg, x)
        return norm_fwd(cfg, params["enc_norm"], x)

    # ------------------------------------------------------------------
    # training forward and loss
    # ------------------------------------------------------------------
    def _units(self, n: int) -> list[tuple[list[int], bool]]:
        """``params["layers"]`` (n entries) cut into the units JAX scans,
        each with whether JAX rematerialises it."""
        cfg = self.cfg
        if self.fam in ("gemma", "zamba"):
            # a super-block's layers; zamba's entries add the shared block
            k = (cfg.local_global_pattern + 1 if self.fam == "gemma"
                 else cfg.shared_attn_every)
            n_super = cfg.n_layers // k
            per = k if self.fam == "gemma" else k + 1
            units = [(list(range(i * per, (i + 1) * per)), True)
                     for i in range(n_super)]
            return units + [([i], False) for i in range(n_super * per, n)]
        first = self.n_dense_layers if self.fam == "moe" else 0
        return [([i], i >= first) for i in range(n)]

    def _layer_fwd(self, params: Params, i: int, x: torch.Tensor,
                   train: bool, memory: torch.Tensor | None):
        p = params["layers"][i]
        if self.fam == "whisper":
            return blocks.cross_fwd(p, self.cfg, x, memory), None
        kind = _kind(p)
        if kind == "moe":
            return blocks.attn_moe_fwd(p, self.cfg, x,
                                       window=self.windows[i], train=train)
        if kind == "ssm":
            return blocks.ssm_fwd(p, self.cfg, x), None
        return blocks.attn_mlp_fwd(p, self.cfg, x,
                                   window=self.windows[i]), None

    def _unit_fwd(self, params: Params, idxs: list[int], x: torch.Tensor,
                  train: bool, memory: torch.Tensor | None):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in idxs:
            x, a = self._layer_fwd(params, i, x, train, memory)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward(self, params: Params, batch: dict, remat: bool = False,
                train: bool = False, remat_policy: str = "none"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward of ``batch`` with no cache: ``tokens`` (B,
        S) from position 0, and ``vision_embeds`` (B, nv, vd) for a model
        with ``n_vision_tokens`` or ``audio_frames`` (B, encoder_seq, d)
        for whisper, tensors or numpy arrays. Returns ``(logits, aux)``:
        the logits (B, nv + S, V) over every position (the image's too)
        and the MoE layers' summed Switch loss (float32 0 without MoE).
        ``train`` routes MoE tokens at the training capacity (JAX's
        ``moe_train_cf``). ``remat`` recomputes each unit's activations in
        the backward (the module docstring). ``remat_policy="collectives"``
        saves the mesh's all-reduce outputs in JAX; one card has no
        collective to save, so it raises."""
        if remat_policy != "none":
            raise ValueError(
                f"remat_policy={remat_policy!r}: only 'none' on one card "
                "('collectives' saves the all-reduce outputs of a mesh, "
                "which one card does not have)")
        as_t = functools.partial(torch.as_tensor, device=self.device)
        tokens = as_t(batch["tokens"]).long()
        memory = None
        if self.fam == "whisper":
            frames = batch.get("audio_frames")
            memory = self._encode(params, None if frames is None
                                  else as_t(frames), tokens.shape[0])
            x = self._embed(params, tokens, None)
        else:
            vis = batch.get("vision_embeds")
            x = self._embed(params, tokens,
                            None if vis is None else as_t(vis))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for idxs, rematted in self._units(len(params["layers"])):
            fn = functools.partial(self._unit_fwd, params, idxs, train=train,
                                   memory=memory)
            if remat and rematted:
                x, a = torch.utils.checkpoint.checkpoint(
                    fn, x, use_reentrant=False)
            else:
                x, a = fn(x)
            aux = aux + a
        return self._head(params, x), aux

    def loss(self, params: Params, batch: dict, remat: bool = False,
             remat_policy: str = "none") -> tuple[torch.Tensor, dict]:
        """JAX's next-token loss of ``batch`` (``forward``'s inputs, plus
        an optional ``loss_mask`` (B, S)): the float32 mean over the
        unmasked targets of ``logsumexp - gold`` (the image's positions
        dropped), plus ``router_aux_loss_coef`` times the MoE aux loss.
        Returns ``(total, {"nll", "moe_aux", "tokens"})``."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch, remat=remat, train=True,
                                   remat_policy=remat_policy)
        if cfg.n_vision_tokens:
            logits = logits[:, cfg.n_vision_tokens:]
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        tgt = tokens[:, 1:]
        lg = logits[:, :-1].float()
        nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, tgt[..., None])[
            ..., 0]
        if "loss_mask" in batch:
            mask = torch.as_tensor(batch["loss_mask"],
                                   device=self.device)[:, 1:].float()
        else:
            mask = torch.ones(tgt.shape, dtype=torch.float32,
                              device=self.device)
        n = mask.sum()
        nll_mean = (nll * mask).sum() / n.clamp_min(1.0)
        total = nll_mean + cfg.router_aux_loss_coef * aux
        return total, {"nll": nll_mean, "moe_aux": aux, "tokens": n}

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Cache,
                logits_at: int | torch.Tensor = -1, *,
                vision_embeds: torch.Tensor | None = None,
                audio_frames: torch.Tensor | None = None,
                row_invariant: bool = False) -> torch.Tensor:
        """tokens: (B, S) from position 0 (from position nv behind the
        image of ``vision_embeds``, (B, nv, vd), for a model with
        ``n_vision_tokens``; whisper's decoder prompt beside its
        ``audio_frames``, (B, encoder_seq, d), which the encoder reads).
        Fills ``cache`` in place and returns the logits (B, V) at
        ``logits_at``, a position of the whole sequence (image included).
        On the card float32 products run in fixed row slices, and with
        ``row_invariant`` every product does, so a row's bits do not
        depend on the batch (``layers.prefill_products``)."""
        with prefill_products(every_dtype=row_invariant):
            if self.fam == "whisper":
                memory = self._encode(params, audio_frames, tokens.shape[0])
                x = self._embed(params, tokens, None)
                for p, c in zip(params["layers"], cache):
                    x = blocks.cross_prefill(p, self.cfg, x, memory, c)
                return self._head(params, self._sel(x, logits_at))
            x = self._embed(params, tokens, vision_embeds)
            for p, c, w in zip(params["layers"], cache, self.windows):
                x = _PREFILL[_kind(p)](p, self.cfg, x, c, window=w)
            return self._head(params, self._sel(x, logits_at))

    def prefill_suffix(self, params: Params, tokens: torch.Tensor,
                       cache: Cache, ctx: list, offset: int,
                       logits_at: int | torch.Tensor = -1, *,
                       row_invariant: bool = False) -> torch.Tensor:
        """Prefill only the residual suffix of prompts whose first
        ``offset`` positions are prefix-cache hits. ``tokens``: (B, S)
        suffix tokens; ``ctx``: one ``{"k", "v"}`` per layer, each
        (B, offset, Hkv, hd), gathered from the shared pages; ``cache``:
        a dense mini-cache of width S, filled in place with the suffix
        K/V. Returns the logits (B, V) at ``logits_at``. The dense and MoE
        families over GQA only, as in JAX. ``row_invariant`` as in
        ``prefill``."""
        if self.fam not in ("dense", "moe") or self.cfg.mla:
            raise ValueError(f"prefix sharing unsupported for {self.fam}")
        with prefill_products(every_dtype=row_invariant):
            x = embed_fwd(params["embed"], tokens)
            for p, c, cx in zip(params["layers"], cache, ctx):
                x = _SUFFIX_PREFILL[_kind(p)](p, self.cfg, x, c, cx["k"],
                                              cx["v"], offset)
            return self._head(params, self._sel(x, logits_at))

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Cache, pos: torch.Tensor) -> torch.Tensor:
        """tokens: (B, 1); pos: (B,) positions of those tokens. Writes
        their keys/values (SSM: conv tails and states) into ``cache`` in
        place; returns logits (B, V). Whisper's tokens get the sinusoid of
        ``pos``, and its layers one all-true memory mask, built in the
        step (so a captured step builds it in the graph)."""
        x = embed_fwd(params["embed"], tokens)
        if self.fam == "whisper":
            x = x + sinusoid(pos[:, None], self.cfg.d_model).to(x.dtype)
            mem = cache[0]["mem_k"]
            valid = torch.ones(mem.shape[:2], dtype=torch.bool,
                               device=mem.device)
            for p, c in zip(params["layers"], cache):
                x = blocks.cross_decode(p, self.cfg, x, c, pos, valid)
            return self._head(params, x[:, -1])
        for p, c in zip(params["layers"], cache):
            x = _DECODE[_kind(p)](p, self.cfg, x, c, pos)
        return self._head(params, x[:, -1])

    def chunk_buffers(self, batch: int, n_tokens: int,
                      device: torch.device | None = None) -> dict:
        """Zeroed device state for ``decode_chunk_step`` over ``batch``
        slots and up to ``n_tokens`` steps: ``tokens``, ``pos``,
        ``remaining`` and ``active`` (0 or 1), each (batch,) int32;
        ``col`` (1,) int64, the block column the next step writes; ``key``
        (2,) int64, the sampler's ``[seed, draw]`` (read and advanced by a
        sampling step only); ``emitted`` (batch,) int32; ``block`` (batch,
        n_tokens) int32.

        All are views of one int32 tensor laid out as [tokens | pos |
        remaining | active | col | key | emitted | the block by step], so
        ``head`` (everything up to ``emitted``) is written from the host
        in one copy and ``out`` (``emitted``, then the block one step of
        ``batch`` tokens after another) read back in one copy of its
        first ``batch * (1 + steps)`` elements."""
        B = batch
        mem = torch.zeros(5 * B + 6 + n_tokens * B, dtype=torch.int32,
                          device=device or self.device)
        state = mem[:4 * B].view(4, B)
        return {"tokens": state[0], "pos": state[1],
                "remaining": state[2], "active": state[3],
                # 16·B bytes in: a valid place for an int64
                "col": mem[4 * B:4 * B + 2].view(torch.int64),
                "key": mem[4 * B + 2:4 * B + 6].view(torch.int64),
                "emitted": mem[4 * B + 6:5 * B + 6],
                "block": mem[5 * B + 6:].view(n_tokens, B).T,
                "head": mem[:5 * B + 6], "out": mem[4 * B + 6:]}

    def decode_chunk_step(self, params: Params, cache: Cache, buf: dict,
                          *, max_len: int, greedy: bool = True) -> None:
        """One step of every slot in lockstep, in place on ``buf``
        (``chunk_buffers``) and ``cache``: an active slot takes the picked
        token (the argmax, or with ``greedy=False`` the Gumbel-max sample
        of draw ``key[1]``, after which the draw advances, as JAX splits
        its key every step) and advances its position and budget, and
        deactivates once its budget reaches 0 or its position ``max_len -
        1``; an inactive slot keeps its state and only writes ignorable
        keys into its own cache row. The step's token of every slot goes
        into ``block`` at column ``col``, ``active`` is added into
        ``emitted``, and ``col`` advances. No host read, so the step can
        be captured in a CUDA graph and replayed."""
        tok, pos, rem = buf["tokens"], buf["pos"], buf["remaining"]
        act = buf["active"].bool()
        logits = self.decode_step(params, tok[:, None], cache, pos)
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = sampling.gumbel_argmax(logits, buf["key"])
            buf["key"][1:].add_(1)
        nxt = torch.where(act, nxt.to(torch.int32), tok)
        new_pos = torch.where(act, pos + 1, pos)
        new_rem = torch.where(act, rem - 1, rem)
        buf["block"].index_copy_(1, buf["col"], nxt[:, None])
        buf["emitted"].add_(act)
        new_act = act & (new_rem > 0) & (new_pos < max_len - 1)
        tok.copy_(nxt)
        pos.copy_(new_pos)
        rem.copy_(new_rem)
        buf["active"].copy_(new_act)
        buf["col"].add_(1)

    def decode_chunk(self, params: Params, cache: Cache, state: dict,
                     n_tokens: int, *, max_len: int, greedy: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Decode of ``n_tokens`` steps for every slot in lockstep:
        ``n_tokens`` calls of ``decode_chunk_step``.

        ``state`` holds device tensors, one entry per slot: ``tokens``
        (last token, int32), ``pos`` (its position), ``remaining``
        (tokens still to emit) and ``active`` (bool); with ``greedy=False``
        also ``key``, the sampler's (2,) int64 ``[seed, draw]``
        (``models/sampling.py``), which advances by one draw a step. An
        active slot emits one token per step and deactivates once
        ``remaining`` reaches 0 or ``pos`` reaches ``max_len - 1``; after
        that its state is frozen and its steps only write ignorable keys
        into its own cache row.

        Returns ``(tokens (B, n_tokens), emitted (B,), new_state)``; per
        slot only the first ``emitted`` tokens of its row are real.
        """
        tokens = state["tokens"]
        buf = self.chunk_buffers(tokens.shape[0], n_tokens, tokens.device)
        names = ("tokens", "pos", "remaining", "active") + (
            () if greedy else ("key",))
        for name in names:
            buf[name].copy_(state[name])
        for _ in range(n_tokens):
            self.decode_chunk_step(params, cache, buf, max_len=max_len,
                                   greedy=greedy)
        new_state = {"tokens": buf["tokens"], "pos": buf["pos"],
                     "remaining": buf["remaining"],
                     "active": buf["active"].bool()}
        if not greedy:
            new_state["key"] = buf["key"]
        return buf["block"], buf["emitted"], new_state
