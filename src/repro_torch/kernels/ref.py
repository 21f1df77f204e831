"""Plain PyTorch versions of the ported kernels.

Each is the numerical contract its CUDA kernel is held to (``chip_smoke.py``
compares them on the card) and the path a CPU tensor takes through
``kernels.ops``. They follow ``repro.kernels.ref``: scores in float32,
``NEG_INF`` fill for masked scores, an optional tanh softcap, queries
right-aligned against the keys (offset ``Skv - Sq``) and the normaliser
clamped at 1e-30. One deliberate difference: masked positions get an
exact 0.0 weight, so a row with no visible key yields 0 — the JAX oracle
spreads such a row uniformly over the masked keys instead.

``mla_decode_ctx`` follows ``repro.kernels.ref.mla_decode_ctx`` (scores
in float32, the context in q_lat's dtype), with the same rule for a row
whose positions are all dead: it gives 0.

``ssd_scan`` follows ``repro.kernels.ref.ssd_scan_seq``: a loop over
chunks, float32 inside, results in x's dtype.

An int8 cache (``k_scale``/``v_scale`` given) is dequantised first,
``codes.float() * scale[..., None]``, as the kernels dequantise a row
when they load it, and then takes the same path; a dead position's scale
is read as 0, so it adds exactly 0.0 whatever its page holds.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    if softcap and softcap > 0.0:
        return torch.tanh(scores / softcap) * softcap
    return scores


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   device: torch.device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row sees. Queries are
    right-aligned: row i sits at key position ``i + Skv - Sq``."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    return mask


def _masked_softmax_weights(scores: torch.Tensor, mask: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unnormalised weights with masked entries exactly 0.0, and their
    row sums clamped at 1e-30 (so an all-masked row gives 0, not NaN)."""
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~mask, 0.0)
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, K); k: (B, Skv, Hkv, K); v: (B, Skv, Hkv, Kv) with
    H % Hkv == 0 (GQA: query head h reads kv head h // (H // Hkv)).
    ``window > 0`` keeps keys less than ``window`` positions behind the
    query. Returns (B, Sq, H, Kv) in q's dtype."""
    B, Sq, H, K = q.shape
    Skv, Hkv, Kv = k.shape[1], k.shape[2], v.shape[3]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, K).float()
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k.float()) * (K ** -0.5)
    scores = _softcap(scores, softcap)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          device=q.device)
    p, l = _masked_softmax_weights(scores, mask)
    out = torch.einsum("bhgqs,bshk->bhgqk", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Kv).to(q.dtype)


def _dequant(codes: torch.Tensor, scale: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """float32 values of int8 ``codes`` (B, W, Hkv, K) with (B, W, Hkv)
    scales; dead positions (``valid`` false) come out 0."""
    scale = torch.where(valid[..., None], scale, 0.0)
    return codes.float() * scale[..., None]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, softcap: float = 0.0,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One query token per sequence against a dense ring cache.

    q: (B, H, K); k/v: (B, W, Hkv, K); valid: (B, W) bool — which ring
    slots hold live entries. With ``k_scale``/``v_scale`` (B, W, Hkv)
    float32, k/v are int8 codes. Returns (B, H, K) in q's dtype; a row
    with no valid slot gives 0."""
    if k_scale is not None:
        k, v = _dequant(k, k_scale, valid), _dequant(v, v_scale, valid)
    B, H, K = q.shape
    Hkv, Kv = k.shape[2], v.shape[3]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, K).float()
    scores = torch.einsum("bhgk,bshk->bhgs", qg, k.float()) * (K ** -0.5)
    scores = _softcap(scores, softcap)
    p, l = _masked_softmax_weights(scores, valid[:, None, None, :])
    out = torch.einsum("bhgs,bshk->bhgk", p, v.float()) / l
    return out.reshape(B, H, Kv).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, *, softcap: float = 0.0,
                           k_scale_pages: torch.Tensor | None = None,
                           v_scale_pages: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """One query token per sequence against a pool of pages, through a
    block table.

    q: (B, H, K); k_pages/v_pages: (P+1, bs, Hkv, K); table: (B, nblk)
    page indices; lengths: (B,) — positions [0, len) are live. With
    ``k_scale_pages``/``v_scale_pages`` (P+1, bs, Hkv) float32 the pages
    hold int8 codes. Gathers the (B, nblk*bs, Hkv, K) logical view (and
    its scales through the same table) and runs ``decode_attention`` with
    ``valid = arange < lengths``, so for the same logical cache it gives
    the dense plain version's bits (dead positions add exactly 0.0 to the
    output, whatever finite values their pages hold, and with int8 pages
    whatever their scale pages hold)."""
    B, nblk = table.shape
    bs = k_pages.shape[1]
    W = nblk * bs
    idx = table.long()
    k = k_pages[idx].reshape(B, W, *k_pages.shape[2:])
    v = v_pages[idx].reshape(B, W, *v_pages.shape[2:])
    ks = vs = None
    if k_scale_pages is not None:
        ks = k_scale_pages[idx].reshape(B, W, k_scale_pages.shape[2])
        vs = v_scale_pages[idx].reshape(B, W, v_scale_pages.shape[2])
    valid = (torch.arange(W, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    return decode_attention(q, k, v, valid, softcap=softcap, k_scale=ks,
                            v_scale=vs)


def mla_decode_ctx(q_lat: torch.Tensor, q_rope: torch.Tensor,
                   ckv: torch.Tensor, k_rope: torch.Tensor,
                   valid: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Absorbed-MLA decode: one query token per sequence attends in the
    latent space.

    q_lat: (B, H, r); q_rope: (B, H, dr); ckv: (B, S, r) latent cache;
    k_rope: (B, S, dr) shared rope keys; valid: (B, S) bool. Scores are
    ``scale * (q_lat·ckvᵀ + q_rope·k_ropeᵀ)`` over the valid positions;
    returns the context ``softmax · ckv`` (B, H, r) in q_lat's dtype (the
    caller applies W_uv and W_o)."""
    scores = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
    scores = scores + torch.einsum("bhk,bsk->bhs", q_rope.float(),
                                   k_rope.float())
    p, l = _masked_softmax_weights(scores * scale, valid[:, None, :])
    out = torch.einsum("bhs,bsr->bhr", p, ckv.float()) / l
    return out.to(q_lat.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD (state-space duality) chunked scan, one chunk at a time.

    x: (B, S, nh, hd); dt: (B, S, nh) (post-softplus, >= 0); A: (nh,)
    (< 0); B_/C_: (B, S, ng, ds) with nh % ng == 0 (head h reads group
    h // (nh / ng)); D: (nh,). Returns (y (B, S, nh, hd), final state
    (B, nh, hd, ds)), both in x's dtype. Within a chunk the quadratic
    form ``(C·Bᵀ ∘ L) · (dt·x)`` with ``L = exp(segsum(dt·A))``; across
    chunks the float32 (nh, hd, ds) state carries, decayed by the chunk's
    total ``exp(sum dt·A)``. Raises unless ``chunk`` divides S, where the
    JAX oracle asserts."""
    Bb, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of "
                         f"chunk={chunk}")
    rep = nh // ng
    f32 = torch.float32
    Af, Df = A.to(f32), D.to(f32)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    state = torch.zeros((Bb, nh, hd, ds), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk].to(f32)                     # (B, Q, nh, hd)
        dtc = dt[:, c0:c0 + chunk].to(f32)                   # (B, Q, nh)
        Bh = B_[:, c0:c0 + chunk].to(f32).repeat_interleave(rep, dim=2)
        Ch = C_[:, c0:c0 + chunk].to(f32).repeat_interleave(rep, dim=2)
        cum = torch.cumsum(dtc * Af, dim=1)                  # (B, Q, nh)
        cs = cum.transpose(1, 2)                             # (B, nh, Q)
        seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(
            ~tri, float("-inf"))
        G = torch.einsum("bqhd,bkhd->bhqk", Ch, Bh)
        y_diag = torch.einsum("bhqk,bkhp->bqhp", G * torch.exp(seg),
                              dtc[..., None] * xc)
        y_off = torch.einsum("bqhd,bhpd->bqhp", Ch, state) \
            * torch.exp(cum)[..., None]
        decay_to_end = torch.exp(cum[:, -1:] - cum)          # (B, Q, nh)
        new = torch.einsum("bqhd,bqhp->bhpd", Bh,
                           (dtc * decay_to_end)[..., None] * xc)
        state = state * torch.exp(cum[:, -1])[..., None, None] + new
        ys.append((y_diag + y_off + xc * Df[:, None]).to(x.dtype))
    return torch.cat(ys, dim=1), state.to(x.dtype)
