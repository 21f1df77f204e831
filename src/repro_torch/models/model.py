"""Model assembly for the dense, MoE and SSM families: init, caches,
prefill, decode.

A port of the dense, moe and ssm paths of ``repro.models.model.Model``.
JAX scans one stacked parameter tree over the layers (for moe, the
``n_dense_layers`` leading dense layers as ``dense0``, then the MoE
``stack``); the port keeps one parameter dict per layer
(``params["layers"]``, in that order) and loops over them.

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
     "layers": [{"ln1", "attn", "ln2", "mlp"} per layer]   (dense)
               [{"ln1", "attn", "ln2", "mlp"} x n_dense_layers,
                {"ln1", "attn", "ln2", "moe"} x the rest]  (moe)
               [{"ln", "mamba"} per layer]                 (ssm)}

where ``attn`` is GQA or, for a config with ``mla``, DeepSeek's latent
attention (``models/attention.py``).

Cache: one ``{"k", "v"}`` dict of (B, max_len, Hkv, hd) tensors per layer,
or, with a ``PagedLayout``, one paged group per layer over a block table
that every layer shares (``models/cache.py``); with
``kv_cache_dtype="int8"`` either holds int8 codes plus float32 scales
(``models/attention.py``). An MLA layer's cache holds its latents,
``{"ckv", "k_rope"}`` rows or ``{"ckv_pages", "k_rope_pages"}`` over the
table. An SSM layer's cache is one ``{"conv", "state"}`` row group
(``models/ssm.py``), which has no paged form: a paged engine keeps
these dense rows beside its block accounting.
Updated in place by ``prefill``, ``prefill_suffix`` and ``decode_step``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import cache as paged
from repro_torch.models import sampling
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_fwd, init_norm, linear_fwd,
                                       norm_fwd, prefill_products, project,
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
    """The port serves the text-only dense family with a full-horizon
    cache, in the model's dtype or int8, the MoE family with GQA or MLA
    attention (deepseek-v2-lite) and the SSM family (mamba2); other
    families and options (a sliding window, as mixtral's) are later
    slices."""
    unsupported = {  # an MLA cache ignores kv_cache_dtype, as in JAX
        "arch_type": cfg.arch_type not in ("dense", "moe", "ssm"),
        "sliding_window": cfg.sliding_window > 0,
        "local_global_pattern": cfg.local_global_pattern > 0,
        "kv_cache_dtype": cfg.kv_cache_dtype not in ("model", "int8"),
        "pos_embed": cfg.pos_embed != "rope",
        "n_vision_tokens": cfg.n_vision_tokens > 0,
        "act": cfg.act != "silu",
        "mlp_gated": not cfg.mlp_gated,
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


class Model:
    """A dense, MoE or SSM decoder on one device (``"cuda"`` unless told
    ``"cpu"``)."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.fam = family(cfg)
        self.device = resolve_device(device)

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
        if self.fam == "ssm":
            p["layers"] = [blocks.init_ssm_block(cfg, dtype, g)
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
        """Leading layers with a dense MLP: all of a dense model's, the
        first ``n_dense_layers`` of an MoE model's."""
        return (self.cfg.n_dense_layers if self.fam == "moe"
                else self.cfg.n_layers)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32,
                   layout: paged.PagedLayout | None = None) -> Cache:
        """Dense rows, or with ``layout`` the paged cache: every layer's
        group refers to one shared (batch, nblk) table. An int8 cache
        (``cfg.kv_cache_dtype``) ignores ``dtype`` for its codes and
        scales. An SSM model's rows are its conv tails and states, which
        ``max_len`` does not size and no layout pages: with a layout it
        gets the same dense rows, ``batch`` of them, and the paged
        engine's block accounting runs over a tree with no paged group,
        as in JAX."""
        cfg = self.cfg
        if self.fam == "ssm":
            return [ssm_lib.init_mamba2_cache(cfg, batch, dtype, self.device)
                    for _ in range(cfg.n_layers)]
        if layout is None:
            init = attn.init_mla_cache if cfg.mla else attn.init_attn_cache
            return [init(cfg, batch, max_len, dtype, self.device)
                    for _ in range(cfg.n_layers)]
        if not paged.pageable(cfg.sliding_window, max_len):
            raise ValueError(f"{cfg.name}: a {cfg.sliding_window}-token "
                             f"window does not page over {max_len}")
        table = paged.new_table(batch, max_len, layout, self.device)
        init = (paged.init_paged_mla_cache if cfg.mla
                else paged.init_paged_attn_cache)
        return [init(cfg, table, layout, dtype) for _ in range(cfg.n_layers)]

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

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Cache,
                logits_at: int | torch.Tensor = -1) -> torch.Tensor:
        """tokens: (B, S) from position 0. Fills ``cache`` in place and
        returns the logits (B, V) at ``logits_at``."""
        with prefill_products():
            x = embed_fwd(params["embed"], tokens)
            for p, c in zip(params["layers"], cache):
                x = _PREFILL[_kind(p)](p, self.cfg, x, c)
            return self._head(params, self._sel(x, logits_at))

    def prefill_suffix(self, params: Params, tokens: torch.Tensor,
                       cache: Cache, ctx: list, offset: int,
                       logits_at: int | torch.Tensor = -1) -> torch.Tensor:
        """Prefill only the residual suffix of prompts whose first
        ``offset`` positions are prefix-cache hits. ``tokens``: (B, S)
        suffix tokens; ``ctx``: one ``{"k", "v"}`` per layer, each
        (B, offset, Hkv, hd), gathered from the shared pages; ``cache``:
        a dense mini-cache of width S, filled in place with the suffix
        K/V. Returns the logits (B, V) at ``logits_at``. The dense and MoE
        families over GQA only, as in JAX."""
        if self.fam not in ("dense", "moe") or self.cfg.mla:
            raise ValueError(f"prefix sharing unsupported for {self.fam}")
        with prefill_products():
            x = embed_fwd(params["embed"], tokens)
            for p, c, cx in zip(params["layers"], cache, ctx):
                x = _SUFFIX_PREFILL[_kind(p)](p, self.cfg, x, c, cx["k"],
                                              cx["v"], offset)
            return self._head(params, self._sel(x, logits_at))

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Cache, pos: torch.Tensor) -> torch.Tensor:
        """tokens: (B, 1); pos: (B,) positions of those tokens. Writes
        their keys/values (SSM: conv tails and states) into ``cache`` in
        place; returns logits (B, V)."""
        x = embed_fwd(params["embed"], tokens)
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
