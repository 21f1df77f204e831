"""GQA attention (+qk_norm) over the dense ring or the paged KV cache, and
DeepSeek's multi-head latent attention (MLA) over the latent cache.

The GQA branches of ``repro.models.attention``, in the model's dtype or
over an int8 cache: ``attn_prefill`` for a prompt with no cache
(whisper's encoder, not causal), ``attn_prefill_into_cache`` for prefill,
``attn_suffix_prefill_into_cache`` for the residual suffix behind a
shared prefix (model dtype only), and ``attn_decode`` for one new token
over the dense ring or the block table; and whisper's cross attention
(``cross_attn_memory``, ``cross_attn_prefill``, ``cross_attn_decode``)
over the encoder's output. All reach the hand-written kernels through
``kernels.ops``.

Cache layout (per layer): ``{"k": (B, W, Hkv, hd), "v": (B, W, Hkv, hd)}``
with ``W`` the ring's width: ``min(window, max_len)`` for a sliding-window
layer (gemma's local layers, mixtral), else ``max_len``; every reader
takes ``W`` from the cache leaf. With
``kv_cache_dtype="int8"`` k/v hold int8 codes and the group adds
``"k_scale"``/``"v_scale"`` (B, W, Hkv) float32, one absmax scale per
(slot, kv head) (``_quant_kv``). Keys are stored post-RoPE; slot ``s``
holds absolute position ``p_s = pos - ((pos - s) mod W)``, which the
decode mask reconstructs. The paged layout is in ``models/cache.py``.

MLA (``init_mla``, ``mla_prefill_into_cache``, ``mla_decode``) caches the
normalised latent and the shared rope key per position, ``{"ckv": (B, L,
r), "k_rope": (B, L, dr)}``, not per-head keys and values. A prefill
wider than L keeps its first L positions (JAX's ``_mla_fill_cache``; the
GQA ring wraps instead), and decode runs absorbed attention in the
latent space through ``kernels.ops.mla_decode_ctx``, over the dense rows
or over the logical view gathered from the latent pages.
Where JAX donated the cache to a jitted step and got a new tree back, the
port writes the new keys and values into the cache tensors in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, project, rmsnorm_fwd,
                                      truncated_normal)


def init_attn(cfg: ArchConfig, dtype: torch.dtype,
              generator: torch.Generator) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {"wq": truncated_normal((d, h, hd), dtype, s, generator),
         "wk": truncated_normal((d, kv, hd), dtype, s, generator),
         "wv": truncated_normal((d, kv, hd), dtype, s, generator),
         "wo": truncated_normal((h, hd, d), dtype, (h * hd) ** -0.5,
                                generator)}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=dtype,
                                           device=generator.device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=dtype,
                                           device=generator.device)}
    return p


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device: torch.device,
                    window: int = 0) -> dict:
    """A zeroed ring ``min(window, max_len)`` wide with a window, else
    ``max_len`` wide."""
    W = min(window, max_len) if window else max_len
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# float32(1/127): XLA compiles the reference's ``absmax / 127.0`` under
# jit as a multiply by this reciprocal, which rounds differently from a
# true division in about one scale in twenty
_INV_127 = torch.tensor(1 / 127, dtype=torch.float32)


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantisation of x (..., hd): codes
    ``round(x / scale)`` clipped to +-127 (half to even) and the float32
    scales ``max(absmax / 127, 1e-8)``, bit for bit as the jitted
    reference computes them."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * _INV_127, 1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _leaves(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor) -> dict:
    """What the cache stores for new keys/values: themselves, or with an
    int8 cache their codes and scales. Keyed like a dense cache group."""
    if cfg.kv_cache_dtype == "int8":
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return project(x, w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, k, d = wo.shape
    return project(o.reshape(*o.shape[:-2], h * k), wo.reshape(h * k, d))


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        # both norms in one launch on the card
        q, k = kops.rmsnorm_pair(q, p["q_norm"]["scale"], k,
                                 p["k_norm"]["scale"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    return q.contiguous(), k.contiguous(), v.contiguous()


def ring_positions(W: int, pos: torch.Tensor) -> torch.Tensor:
    """Absolute position stored in each ring slot after writing at ``pos``.
    pos: (B,) -> (B, W); negative entries were never written."""
    slots = torch.arange(W, device=pos.device)[None, :]
    p = pos[:, None]
    return p - torch.remainder(p - slots, W)


def attn_prefill_into_cache(p: dict, cfg: ArchConfig, x: torch.Tensor,
                            cache: dict, *, window: int = 0) -> torch.Tensor:
    """Causal prefill of x (B, S, d) from position 0, each query seeing
    the ``window`` keys up to its own with a window; leaves the last W
    keys/values in the ring (written in place). Returns (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    out = kops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_logit_softcap)
    y = _out(out, p["wo"])
    W = cache["k"].shape[1]
    if S <= W:
        slots = slice(0, S)
    else:
        # positions [S-W, S) land in slots p % W (scales follow them)
        slots = torch.remainder(torch.arange(S - W, S, device=x.device), W)
        k, v = k[:, S - W:], v[:, S - W:]
    for name, t in _leaves(cfg, k, v).items():
        cache[name][:, slots] = t.to(cache[name].dtype)
    return y


def attn_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                 causal: bool = True) -> torch.Tensor:
    """Prompt attention of x (B, S, d) from position 0 with no cache
    (whisper's encoder runs it with ``causal=False``). Returns (B, S,
    d)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    out = kops.flash_attention(q, k, v, causal=causal, window=0,
                               softcap=cfg.attn_logit_softcap)
    return _out(out, p["wo"])


def cross_attn_memory(p: dict, cfg: ArchConfig, memory: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's keys and values (B, S_mem, Hkv, hd) of the
    encoder output ``memory`` (B, S_mem, d), in its dtype against the
    weights' (float32 frames keep them float32, as JAX promotes)."""
    return (_proj(memory, p["wk"]).contiguous(),
            _proj(memory, p["wv"]).contiguous())


def cross_attn_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Decoder cross attention of x (B, S, d) over the whole memory
    (k, v: (B, S_mem, Hkv, hd)), not causal. Queries in another dtype
    than the memory (bfloat16 against float32) run in the memory's, an
    exact cast up, and the output comes back in the queries' dtype: JAX's
    oracle computes in float32 and returns q's dtype, and the card
    kernel takes one dtype. Returns (B, S, d)."""
    q = _proj(x, p["wq"]).contiguous()
    out = kops.flash_attention(q.to(k.dtype), k, v, causal=False, window=0,
                               softcap=cfg.attn_logit_softcap)
    return _out(out.to(q.dtype), p["wo"])


def cross_attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """One query token x (B, 1, d) against the whole memory (k, v: (B,
    S_mem, Hkv, hd), in the cache's dtype) through the decode kernel
    (``kernels.ops.decode_cross_attention``); ``valid`` is the step's
    all-true (B, S_mem) mask, one tensor for every layer. Returns (B, 1,
    d)."""
    q = _proj(x, p["wq"])[:, 0].contiguous()
    out = kops.decode_cross_attention(q, k, v, valid,
                                      softcap=cfg.attn_logit_softcap)
    return _out(out, p["wo"])[:, None]


def attn_suffix_prefill_into_cache(p: dict, cfg: ArchConfig, x: torch.Tensor,
                                   cache: dict, ctx_k: torch.Tensor,
                                   ctx_v: torch.Tensor,
                                   offset: int) -> torch.Tensor:
    """Prefill only the residual suffix x (B, S, d) behind ``offset``
    already-cached positions (prefix sharing). Queries sit at rope
    positions ``offset + i``; keys/values are [ctx (B, offset, Hkv, hd),
    suffix], and causal attention right-aligns the queries, so the context
    width must be ``offset`` exactly. Writes the suffix K/V into ``cache``
    (width S) in place. Returns (B, S, d). A cache in the model's dtype
    only: the engine shares no prefix of an int8 cache, as in JAX."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("suffix prefill over an int8 cache")
    B, S, _ = x.shape
    positions = offset + torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    ck = torch.cat([ctx_k.to(k.dtype), k], dim=1)
    cv = torch.cat([ctx_v.to(v.dtype), v], dim=1)
    out = kops.flash_attention(q, ck, cv, causal=True, window=0,
                               softcap=cfg.attn_logit_softcap)
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    return _out(out, p["wo"])


def attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                pos: torch.Tensor) -> torch.Tensor:
    """x: (B, 1, d); pos: (B,) — each sequence's position of the new
    token. Writes the token's key/value into its ring slot, or its page
    ``(table[b, pos // bs], pos % bs)``, in place and attends over the
    live positions. With an int8 cache the token is stored as codes and
    scales, and attention reads the cache through the int8 kernels.
    Returns (B, 1, d)."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    new = _leaves(cfg, k[:, 0], v[:, 0])
    bidx = torch.arange(B, device=x.device)
    if "k_pages" in cache:
        # idle rows point at the scratch page; only full-horizon layers
        # are paged, so the live positions are simply [0, pos]
        table = cache["table"]
        bs = cache["k_pages"].shape[1]
        pos = pos.long()
        page = table[bidx, pos // bs].long()
        off = torch.remainder(pos, bs)
        for name, t in new.items():
            pages = cache[f"{name}_pages"]
            pages[page, off] = t.to(pages.dtype)
        lengths = (pos + 1).to(torch.int32)
        out = kops.paged_decode_attention(
            q[:, 0], cache["k_pages"], cache["v_pages"], table, lengths,
            softcap=cfg.attn_logit_softcap,
            k_scale_pages=cache.get("k_scale_pages"),
            v_scale_pages=cache.get("v_scale_pages"))
        return _out(out, p["wo"])[:, None]
    W = cache["k"].shape[1]
    slot = torch.remainder(pos, W)
    for name, t in new.items():
        cache[name][bidx, slot] = t.to(cache[name].dtype)
    valid = ring_positions(W, pos) >= 0
    out = kops.decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                                softcap=cfg.attn_logit_softcap,
                                k_scale=cache.get("k_scale"),
                                v_scale=cache.get("v_scale"))
    return _out(out, p["wo"])[:, None]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent cache, absorbed decode
# ---------------------------------------------------------------------------
def init_mla(cfg: ArchConfig, dtype: torch.dtype,
             generator: torch.Generator) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                     cfg.qk_nope_head_dim, cfg.v_head_dim)
    s = d ** -0.5
    return {"wq": truncated_normal((d, h, dn + dr), dtype, s, generator),
            # latent + shared rope key
            "w_dkv": truncated_normal((d, r + dr), dtype, s, generator),
            "w_uk": truncated_normal((r, h, dn), dtype, r ** -0.5,
                                     generator),
            "w_uv": truncated_normal((r, h, dv), dtype, r ** -0.5,
                                     generator),
            "wo": truncated_normal((h, dv, d), dtype, (h * dv) ** -0.5,
                                   generator),
            "kv_norm": {"scale": torch.ones((r,), dtype=dtype,
                                            device=generator.device)}}


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_q(p: dict, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """Queries split into their no-rope part and their rotated rope part."""
    dn = cfg.qk_nope_head_dim
    q = _proj(x, p["wq"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latents(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """The normalised latent (B, S, r) and the rotated shared rope key
    (B, S, dr) of x (B, S, d): what the cache stores."""
    r = cfg.kv_lora_rank
    dkv = project(x, p["w_dkv"])
    ckv = rmsnorm_fwd(p["kv_norm"], dkv[..., :r], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)
    return ckv, k_rope[:, :, 0]


def mla_prefill_into_cache(p: dict, cfg: ArchConfig, x: torch.Tensor,
                           cache: dict) -> torch.Tensor:
    """Causal MLA prefill of x (B, S, d) from position 0: per-head keys
    [k_nope | k_rope broadcast over the heads] and values expanded from
    the latent, attention through ``kernels.ops.flash_attention`` (K =
    dn + dr, Kv = dv). Writes the first ``min(L, S)`` latents and rope
    keys into the cache rows in place. Returns (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv, k_rope = _mla_latents(p, cfg, x, positions)
    k_nope = _proj(ckv, p["w_uk"])
    v = _proj(ckv, p["w_uv"]).contiguous()
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, cfg.n_heads, cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = kops.flash_attention(q, k, v, causal=True, window=0)
    take = min(cache["ckv"].shape[1], S)
    cache["ckv"][:, :take] = ckv[:, :take].to(cache["ckv"].dtype)
    cache["k_rope"][:, :take] = k_rope[:, :take].to(cache["k_rope"].dtype)
    return _out(out, p["wo"])


def mla_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> torch.Tensor:
    """Absorbed MLA decode of x (B, 1, d) at positions pos (B,): writes
    the token's latent and rope key into its cache row, or into its page
    ``(table[b, pos // bs], pos % bs)``, in place; folds W_uk into the
    query (``q_lat = q_nope·W_uk``), attends in the latent space over
    positions [0, pos] (a paged cache is gathered into its logical view
    first, as JAX does), casts the context to the cache's dtype and
    applies W_uv and W_o. Returns (B, 1, d)."""
    B = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv_new, kr_new = _mla_latents(p, cfg, x, positions)
    bidx = torch.arange(B, device=x.device)
    pos = pos.long()
    if "ckv_pages" in cache:
        table = cache["table"]
        ckv_pages, kr_pages = cache["ckv_pages"], cache["k_rope_pages"]
        bs = ckv_pages.shape[1]
        page = table[bidx, pos // bs].long()
        off = torch.remainder(pos, bs)
        ckv_pages[page, off] = ckv_new[:, 0].to(ckv_pages.dtype)
        kr_pages[page, off] = kr_new[:, 0].to(kr_pages.dtype)
        idx = table.long()
        S = idx.shape[1] * bs
        ckv = ckv_pages[idx].reshape(B, S, ckv_pages.shape[2])
        k_rope = kr_pages[idx].reshape(B, S, kr_pages.shape[2])
    else:
        ckv, k_rope = cache["ckv"], cache["k_rope"]
        ckv[bidx, pos] = ckv_new[:, 0].to(ckv.dtype)
        k_rope[bidx, pos] = kr_new[:, 0].to(k_rope.dtype)
        S = ckv.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])
    ctx = kops.mla_decode_ctx(q_lat.contiguous(), q_rope[:, 0].contiguous(),
                              ckv, k_rope, valid,
                              scale=(dn + dr) ** -0.5).to(ckv.dtype)
    out = torch.einsum("bhr,rhk->bhk", ctx, p["w_uv"])
    return _out(out, p["wo"])[:, None]
