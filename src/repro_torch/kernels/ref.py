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

``rmsnorm`` is the body of ``repro.models.layers.rmsnorm_fwd`` (and
``repro.kernels.ref.rmsnorm``): float32 arithmetic, x's dtype out.

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


def _masked_softmax_weights(scores: torch.Tensor, mask: torch.Tensor,
                            with_max: bool = False) -> tuple:
    """Unnormalised weights with masked entries exactly 0.0, and their
    row sums clamped at 1e-30 (so an all-masked row gives 0, not NaN);
    with ``with_max`` also the row maxima they are taken against."""
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p, l, m[..., 0]) if with_max else (p, l)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, K); k: (B, Skv, Hkv, K); v: (B, Skv, Hkv, Kv) with
    H % Hkv == 0 (GQA: query head h reads kv head h // (H // Hkv)).
    ``window > 0`` keeps keys less than ``window`` positions behind the
    query. Returns (B, Sq, H, Kv) in q's dtype."""
    return flash_attention_lse(q, k, v, causal=causal, window=window,
                               softcap=softcap)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` (the same bits) and each row's log-sum-exp
    ``m + log(l)`` of its visible scores, (B, H, Sq) float32: what the
    backward reads (``repro.kernels.flash_ref._fwd_impl``'s ``lse``)."""
    B, Sq, H, K = q.shape
    Skv, Hkv, Kv = k.shape[1], k.shape[2], v.shape[3]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, K).float()
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k.float()) * (K ** -0.5)
    scores = _softcap(scores, softcap)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          device=q.device)
    p, l, m = _masked_softmax_weights(scores, mask, with_max=True)
    out = torch.einsum("bhgqs,bshk->bhgqk", p, v.float()) / l
    lse = (m + torch.log(l[..., 0])).reshape(B, H, Sq)
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Kv).to(q.dtype),
            lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of ``flash_attention`` at (q, k, v)
    given its ``out``, its ``lse`` ((B, H, Sq), ``flash_attention_lse``)
    and the output's gradient ``dout``, as
    ``repro.kernels.flash_ref._bwd_impl`` computes them: the probabilities
    recomputed as ``exp(score - lse)`` (0 where masked), ``delta = Σ
    dout·out`` a row, ``ds = p · (dout·vᵀ - delta)`` (times ``1 - t²``
    under a softcap ``t = tanh(s / cap)``), ``dq = scale · ds·k``, ``dk =
    scale · dsᵀ·q`` and ``dv = pᵀ·dout`` summed over the G query heads of
    each kv head, in float32, each returned in its input's dtype."""
    B, Sq, H, K = q.shape
    Skv, Hkv, Kv = k.shape[1], k.shape[2], v.shape[3]
    g = H // Hkv
    scale = K ** -0.5
    qg = q.reshape(B, Sq, Hkv, g, K).float()
    kf, vf = k.float(), v.float()
    sr = torch.einsum("bqhgk,bshk->bhgqs", qg, kf) * scale
    t = torch.tanh(sr / softcap) if softcap and softcap > 0.0 else None
    sc = sr if t is None else t * softcap
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          device=q.device)
    lse_g = lse.float().reshape(B, Hkv, g, Sq)[..., None]
    p = torch.exp(sc.masked_fill(~mask, NEG_INF) - lse_g).masked_fill(
        ~mask, 0.0)
    dog = dout.reshape(B, Sq, Hkv, g, Kv).float()
    delta = (dog * out.reshape(B, Sq, Hkv, g, Kv).float()).sum(-1)
    dp = torch.einsum("bqhgk,bshk->bhgqs", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhgqs,bshk->bqhgk", ds, kf) * scale
    dk = torch.einsum("bhgqs,bqhgk->bshk", ds, qg) * scale
    dv = torch.einsum("bhgqs,bqhgk->bshk", p, dog)
    return (dq.reshape(B, Sq, H, K).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_: torch.Tensor, C_: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, dstate: torch.Tensor | None = None, *,
                 chunk: int = 64) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, ddt, dA, dB_, dC_, dD)`` of ``ssd_scan`` at
    (x, dt, A, B_, C_, D) given ``dy`` (B, S, nh, hd) and the final
    state's gradient ``dstate`` (B, nh, hd, ds; None counts as 0), derived
    by hand, in float32, each returned in its input's dtype.

    A first walk over the chunks recomputes the state S_c entering each;
    a second walks them in reverse carrying dS, the gradient of the state
    leaving the chunk (``dstate`` after the last). In a chunk, with
    ``cum`` the inclusive running sum of dt·A, ``w[t, k] = exp(cum_t -
    cum_k)`` for k <= t (else 0), ``e_k = exp(cum_last - cum_k)``, ``G =
    C·Bᵀ`` and ``R = dy·xᵀ`` (over hd):

    * dx_k = Σ_t G w dt_k dy_t + e_k dt_k (dS·B_k) + D dy_k;
    * dG = w dt_k R, dB_k = Σ_t dG[t, k] C_t + e_k dt_k (x_kᵀ·dS),
      dC_t = Σ_k dG[t, k] B_k + exp(cum_t) (dy_tᵀ·S_c);
    * dcum_t = Σ_k P[t, k] - Σ_t' P[t', t] + exp(cum_t) dy_t·(S_c C_t)
      - U_t, plus exp(cum_last) <dS, S_c> + Σ_k U_k at the last
      position, with P = G w dt_k R and U_k = e_k dt_k x_kᵀ·dS·B_k;
    * the reverse running sum rc of dcum gives ddt_k = Σ_t G w R + e_k
      x_kᵀ·dS·B_k + A rc_k and dA = Σ dt·rc; dD = Σ dy·x;
    * the state entering the chunk takes dS <- exp(cum_last) dS + Σ_t
      exp(cum_t) dy_t ⊗ C_t.

    dB_ and dC_ sum over the heads of a group. Raises unless ``chunk``
    divides S, as ``ssd_scan`` does."""
    Bb, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan_bwd: S={S} is not a multiple of "
                         f"chunk={chunk}")
    rep = nh // ng
    f32 = torch.float32
    Af, Df = A.to(f32), D.to(f32)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()

    def cut(c0):
        sl = slice(c0, c0 + chunk)
        return (x[:, sl].to(f32), dt[:, sl].to(f32),
                B_[:, sl].to(f32).repeat_interleave(rep, dim=2),
                C_[:, sl].to(f32).repeat_interleave(rep, dim=2))

    starts = list(range(0, S, chunk))
    state = torch.zeros((Bb, nh, hd, ds), dtype=f32, device=x.device)
    entering = []
    for c0 in starts:
        entering.append(state)
        xc, dtc, Bh, _ = cut(c0)
        cum = torch.cumsum(dtc * Af, dim=1)
        wk = dtc * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bqhd,bqhp->bhpd", Bh, wk[..., None] * xc)

    dS = (torch.zeros((Bb, nh, hd, ds), dtype=f32, device=x.device)
          if dstate is None else dstate.to(f32))
    dx = torch.empty((Bb, S, nh, hd), dtype=f32, device=x.device)
    ddt = torch.empty((Bb, S, nh), dtype=f32, device=x.device)
    dBh = torch.empty((Bb, S, nh, ds), dtype=f32, device=x.device)
    dCh = torch.empty((Bb, S, nh, ds), dtype=f32, device=x.device)
    dA = torch.zeros((nh,), dtype=f32, device=x.device)
    dD = torch.zeros((nh,), dtype=f32, device=x.device)
    for c0, Sc in zip(reversed(starts), reversed(entering)):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bh, Ch = cut(c0)
        dyc = dy[:, sl].to(f32)
        cum = torch.cumsum(dtc * Af, dim=1)                  # (B, Q, nh)
        last = cum[:, -1]                                    # (B, nh)
        cs = cum.transpose(1, 2)                             # (B, nh, Q)
        w = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(
            ~tri, float("-inf")))                            # [t, k]
        dtk = dtc.transpose(1, 2)[:, :, None, :]             # dt_k
        G = torch.einsum("bqhd,bkhd->bhqk", Ch, Bh)
        R = torch.einsum("bqhp,bkhp->bhqk", dyc, xc)
        Q = G * w * R
        dG = w * dtk * R
        e = torch.exp(last[:, None] - cum)                   # (B, Q, nh)
        ecum = torch.exp(cum)
        E = torch.einsum("bkhd,bhpd->bkhp", Bh, dS)          # dS·B_k
        dx[:, sl] = (torch.einsum("bhqk,bqhp->bkhp", G * w * dtk, dyc)
                     + (e * dtc)[..., None] * E + dyc * Df[:, None])
        V = (xc * E).sum(-1)                                 # x_kᵀ·dS·B_k
        F = torch.einsum("bkhp,bhpd->bkhd", xc, dS)
        H = torch.einsum("bqhp,bhpd->bqhd", dyc, Sc)
        dBh[:, sl] = (torch.einsum("bhqk,bqhd->bkhd", dG, Ch)
                      + (e * dtc)[..., None] * F)
        dCh[:, sl] = (torch.einsum("bhqk,bkhd->bqhd", dG, Bh)
                      + ecum[..., None] * H)
        U = e * dtc * V
        dcum = ((Q * dtk).sum(-1).transpose(1, 2)
                - dtc * Q.sum(-2).transpose(1, 2)
                + ecum * (H * Ch).sum(-1) - U)
        dcum[:, -1] += (torch.exp(last) * (dS * Sc).sum((-2, -1))
                        + U.sum(1))
        rc = dcum.flip(1).cumsum(1).flip(1)
        ddt[:, sl] = Q.sum(-2).transpose(1, 2) + e * V + Af * rc
        dA += (dtc * rc).sum((0, 1))
        dD += (dyc * xc).sum((0, 1, 3))
        dS = dS * torch.exp(last)[..., None, None] + torch.einsum(
            "bqhp,bqhd->bhpd", dyc * ecum[..., None], Ch)
    dB = dBh.reshape(Bb, S, ng, rep, ds).sum(3)
    dC = dCh.reshape(Bb, S, ng, rep, ds).sum(3)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B_.dtype), dC.to(C_.dtype), dD.to(D.dtype))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) → x * rsqrt(mean(x²) + eps) * scale over the
    last axis, in float32, returned in x's dtype (``repro.kernels.ref
    .rmsnorm`` and ``repro.models.layers.rmsnorm_fwd``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dx, dscale)`` of ``rmsnorm`` at (x, scale) given
    the output's gradient ``dy``, in float32: with ``r = rsqrt(mean(x²) +
    eps)`` and ``gs = dy·scale``, ``dx = r·gs - x·r³·mean(x·gs)`` a row
    and ``dscale = Σ dy·x·r`` over every row; each in its input's
    dtype."""
    xf, gs = x.float(), dy.float() * scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dx = r * gs - xf * r.pow(3) * (xf * gs).mean(dim=-1, keepdim=True)
    dscale = (dy.float() * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
