"""The bfloat16 attention gradient's order of sums, on the CPU, against JAX.

``csrc/flash_attention_bwd_bf16.cu`` computes dK and dV in a walk over key
tiles: a work item is a tile of 64 keys of one kv head and batch row, and
walks the 64-row query tiles of its G query heads, head by head, ascending,
rounding P and dS to bfloat16 before dV += P^T.dO and dK += dS^T.Q, which
sum in float32 and are rounded once an item. dQ comes from a pass over
query tiles: each walks the 64-key tiles its rows see in ascending order,
adds dQ += dS.K (dS rounded to bfloat16) into a float32 sum, and scales and
rounds it once. ``_walk_bwd`` below does the same arithmetic in plain
PyTorch, in the same orders, and is held to JAX's
``repro.kernels.flash_ref._bwd_impl`` on bfloat16 inputs (out and lse from
JAX's ``_fwd_impl``) at ``tests/test_torch_flash_bwd.py``'s bfloat16 gate:
every element within 2e-2 of max|JAX| (bfloat16 outputs, float32 sums).
One causal GQA case, one windowed softcap case with query rows
right-aligned against more keys, and one with the widest heads, from a
seeded numpy generator.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16_TOL = 2e-2     # of max|JAX|, as test_torch_flash_bwd.py's bfloat16 gate
BM = 64             # query rows a tile
BN = 64             # keys a tile


def _walk_bwd(q, k, v, out, lse, dout, *, causal, window, softcap):
    """(dq, dk, dv) in bfloat16 by the kernels' orders of sums."""
    B, Sq, H, K = q.shape
    Skv, Hkv, Kv = k.shape[1], k.shape[2], v.shape[3]
    G, off, scale = H // Hkv, Skv - Sq, K ** -0.5
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    delta = (df * out.float()).sum(-1)                      # (B, Sq, H)
    mask = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                              device=q.device)
    acc = torch.zeros(B, H, Sq, K)
    dk = torch.zeros(B, Skv, Hkv, K, dtype=torch.bfloat16)
    dv = torch.zeros(B, Skv, Hkv, Kv, dtype=torch.bfloat16)
    for t in range(-(-Skv // BN)):            # dQ's order: key tiles ascending
        k0, k1 = t * BN, min(t * BN + BN, Skv)
        q_begin = (max(0, k0 - off) // BM) * BM if causal else 0
        q_end = min(Sq, k1 - 1 + window - off) if window > 0 else Sq
        for b in range(B):
            for hk in range(Hkv):
                dk_sum = torch.zeros(k1 - k0, K)
                dv_sum = torch.zeros(k1 - k0, Kv)
                kt, vt = kf[b, k0:k1, hk], vf[b, k0:k1, hk]
                for h in range(hk * G, hk * G + G):
                    for q0 in range(q_begin, q_end, BM):
                        q1 = min(q0 + BM, Sq)
                        qt, dot = qf[b, q0:q1, h], df[b, q0:q1, h]
                        s = kt @ qt.T * scale                  # S^T
                        if softcap > 0:
                            cap = torch.tanh(s / softcap)
                            x, dcap = cap * softcap, 1 - cap * cap
                        else:
                            x, dcap = s, 1.0
                        seen = mask[q0:q1, k0:k1].T
                        p = torch.where(seen, torch.exp(x - lse[b, h, q0:q1]),
                                        0.0)
                        ds = p * (vt @ dot.T - delta[b, q0:q1, h]) * dcap
                        pb = p.bfloat16().float()
                        dsb = ds.bfloat16().float()
                        dv_sum += pb @ dot
                        dk_sum += dsb @ qt
                        acc[b, h, q0:q1] += dsb.T @ kt
                dk[b, k0:k1, hk] = (dk_sum * scale).bfloat16()
                dv[b, k0:k1, hk] = dv_sum.bfloat16()
    dq = (acc * scale).permute(0, 2, 1, 3).bfloat16()
    return dq, dk, dv


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,K,Kv,causal,window,softcap", [
    (2, 300, 300, 4, 2, 64, 64, True, 0, 0.0),       # causal GQA
    (1, 200, 330, 4, 2, 48, 32, True, 70, 5.0),      # window, softcap
    (1, 150, 150, 2, 1, 256, 128, True, 0, 0.0),     # the widest heads
], ids=["causal-gqa", "window-softcap", "wide-heads"])
def test_walk_order_of_sums_matches_jax(B, Sq, Skv, H, Hkv, K, Kv, causal,
                                        window, softcap):
    rng = np.random.default_rng(7)
    q, k, v, dout = (
        rng.standard_normal(s).astype(np.float32)
        for s in ((B, Sq, H, K), (B, Skv, Hkv, K), (B, Skv, Hkv, Kv),
                  (B, Sq, H, Kv)))
    jq, jk, jv, jd = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, dout))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_ref._fwd_impl(jq, jk, jv, block_q=64, block_k=64, **kw)
    want = flash_ref._bwd_impl(jq, jk, jv, out, lse, jd, block_q=64,
                               block_k=64, **kw)
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v, dout)]
    tout = torch.from_numpy(np.asarray(jnp.asarray(out, jnp.float32))
                            ).bfloat16()
    tlse = torch.from_numpy(np.asarray(lse, np.float32)).reshape(B, H, Sq)
    got = _walk_bwd(t[0], t[1], t[2], tout, tlse, t[3], **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= BF16_TOL * float(np.abs(w).max()), (name, err)
