"""The rounding plan of the bfloat16 tensor-core kernels, emulated on the CPU.

The bfloat16 instantiations of ``csrc/flash_attention.cu`` and
``csrc/ssd_scan.cu`` run their products on bf16 tensor cores with float32
accumulators.  A product of two bf16 values is exact in float32, so q·kᵀ
and every product with a bf16 operand (v, x) lose nothing but the float32
sums; a float32 operand enters as a bf16 pair hi = bf16(a), lo = bf16(a -
hi), which takes two products against a bf16 operand and three (hi·hi +
hi·lo + lo·hi) between two float32 operands.  This file emulates that
arithmetic in torch (float32 matrix products of bf16-valued operands) at
small shapes that keep the serving widths (hd 112 with GQA; hp = st = 64
and 6 heads, which the kernel's head blocks of 4 divide unevenly), and
holds it against the plain versions within
chip_smoke's ``MODEL_TOL``, computed as its ``tol_ratio`` computes it.

It also shows why the split is there: with plain bf16 p (flash attention)
or plain bf16 B and C (SSD scan) the same emulation misses those bounds
many times over.  Inputs come from numpy seeds; nothing here needs a card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

#: chip_smoke.py's MODEL_TOL: relative to the largest |plain output|; a
#: bfloat16 output gets one bfloat16 ulp on top
MODEL_TOL = {"flash_attention": 1e-5, "ssd_scan": 1e-4}
KV_TILE = 64  # keys a tile of the flash kernel's online softmax


def bf16_ulp(x):
    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def tol_ratio(got, want, name: str) -> float:
    """Largest error over its bound, as chip_smoke.py computes it."""
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        err = err - torch.maximum(bf16_ulp(g), bf16_ulp(w))
    bound = MODEL_TOL[name] * max(float(w.abs().max()), 1e-30)
    return max(float(err.max()), 0.0) / bound


def rounded(a):
    """a's values rounded to bf16, held in float32."""
    return a.bfloat16().float()


def split(a):
    hi = rounded(a)
    return hi, rounded(a - hi)


def mm2(a, b):
    """a @ b, a float32 as a hi/lo pair, b bf16-valued: two products."""
    hi, lo = split(a)
    return hi @ b + lo @ b


def mm3(a, b):
    """a @ b, both float32 as hi/lo pairs: three products."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + ah @ bl + al @ bh


def randn(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale
                             ).astype(np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_emulated(q, k, v, causal: bool, split_p: bool = True):
    """The kernel's arithmetic: q·kᵀ exact products with float32 sums, the
    scale times log2(e) applied to s, an online softmax over tiles of 64
    keys in float32, and p·V with p as hi + lo (or plain bf16 p)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    c = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
         * torch.tensor(math.log2(math.e), dtype=torch.float32))
    qf = q.float().permute(0, 2, 1, 3)                        # (B,H,S,hd)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    m = torch.full((B, H, S), -math.inf)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for t0 in range(0, T, KV_TILE):
        kt, vt = kf[:, :, t0:t0 + KV_TILE], vf[:, :, t0:t0 + KV_TILE]
        s = (qf @ kt.transpose(-1, -2)) * c
        if causal:
            kpos = torch.arange(t0, t0 + kt.shape[2])[None, :]
            s = s.masked_fill(kpos > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        base = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = mm2(p, vt) if split_p else rounded(p) @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_inputs():
    """The serving head dim with GQA (4 query heads on 2 kv heads)."""
    B, S, T, H, K, hd = 1, 256, 256, 4, 2, 112
    return tuple(randn(shape, seed).bfloat16() for shape, seed in (
        ((B, S, H, hd), 1), ((B, T, K, hd), 2), ((B, T, K, hd), 3)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_split_p_holds_the_bound(causal):
    q, k, v = flash_inputs()
    ratio = tol_ratio(flash_emulated(q, k, v, causal),
                      FA.flash_attention_ref(q, k, v, causal=causal),
                      "flash_attention")
    assert ratio <= 0.25, ratio


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16_p_misses_the_bound(causal):
    q, k, v = flash_inputs()
    ratio = tol_ratio(flash_emulated(q, k, v, causal, split_p=False),
                      FA.flash_attention_ref(q, k, v, causal=causal),
                      "flash_attention")
    assert ratio > 15.0, ratio


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_emulated(x, dt, A, B, C, chunk: int, split_bc: bool = True):
    """The three kernels' arithmetic.  Chunk states (x w)ᵀ B and the offset
    C hᵀ take three products; C Bᵀ three, formed once per chunk and shared
    by the heads of a head block (the same tile for every head block); the
    masked M = C Bᵀ ∘ L ∘ dt against bf16 x two; the pass over chunks runs
    in float32.  cum is the reference's own cumulative sum (the kernel sums
    in the same order on the card).  With ``split_bc=False``, B and C enter
    as plain bf16 instead."""
    b, S, nh, hp = x.shape
    st = B.shape[-1]
    nc, Q = S // chunk, chunk
    xc = x.float().reshape(b, nc, Q, nh, hp)
    dtc = dt.reshape(b, nc, Q, nh)
    Bc, Cc = B.reshape(b, nc, Q, st), C.reshape(b, nc, Q, st)
    cum = torch.cumsum(dtc * A, dim=2)                      # (b,nc,Q,nh)
    total = cum[:, :, -1]                                   # (b,nc,nh)

    def mm_bc(a, bc):  # a float32, bc = B or C (or its transpose)
        return mm2(a, rounded(bc)) if not split_bc else mm3(a, bc)

    # 1. each chunk's own state, (x w)^T B
    w = torch.exp(total[:, :, None, :] - cum) * dtc
    xw_t = (xc * w[..., None]).permute(0, 1, 3, 4, 2)       # (b,nc,nh,hp,Q)
    S_c = mm_bc(xw_t, Bc[:, :, None])                       # (b,nc,nh,hp,st)
    # 2. the pass over chunks
    h = torch.zeros((b, nh, hp, st))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c])[..., None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)
    # 3. the output: C B^T once for all heads, then per head
    if split_bc:
        CB = mm3(Cc, Bc.transpose(-1, -2))
    else:
        CB = rounded(Cc) @ rounded(Bc).transpose(-1, -2)
    seg = cum.permute(0, 1, 3, 2)                           # (b,nc,nh,Q)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    L = torch.exp((seg[..., :, None] - seg[..., None, :]).masked_fill(
        ~tril, -math.inf))
    M = CB[:, :, None] * L * dtc.permute(0, 1, 3, 2)[..., None, :]
    x_h = xc.permute(0, 1, 3, 2, 4)                         # (b,nc,nh,Q,hp)
    y_diag = mm2(M, x_h)
    C_h = Cc[:, :, None].expand(b, nc, nh, Q, st)
    y_off = (mm_bc(h_prev, C_h.transpose(-1, -2)).transpose(-1, -2)
             * torch.exp(seg)[..., None])
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, S, nh, hp)
    return y.to(x.dtype), h


def ssd_inputs():
    """The card tests' SSD inputs at the serving widths: positive steps dt
    around 0.1 and decay rates A around -1, so that the state carried
    between chunks counts; x bf16, B and C float32."""
    b, S, nh, hp, st = 1, 512, 6, 64, 64
    rng = np.random.default_rng(7)
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal(
        (b, S, nh)))) * 0.1).astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(nh) * 0.3)
                          ).astype(np.float32))
    return (randn((b, S, nh, hp), 8, 0.5).bfloat16(), dt, A,
            randn((b, S, st), 9, 0.5), randn((b, S, st), 10, 0.5))


@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_split_holds_the_bound(chunk):
    args = ssd_inputs()
    y, h = ssd_emulated(*args, chunk=chunk)
    y_ref, h_ref = SSD.ssd_scan_ref(*args, chunk=chunk)
    ratios = (tol_ratio(y, y_ref, "ssd_scan"),
              tol_ratio(h, h_ref, "ssd_scan"))
    assert max(ratios) <= 0.25, ratios


@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_plain_bf16_b_and_c_miss_the_bound(chunk):
    args = ssd_inputs()
    y, h = ssd_emulated(*args, chunk=chunk, split_bc=False)
    y_ref, h_ref = SSD.ssd_scan_ref(*args, chunk=chunk)
    ratios = (tol_ratio(y, y_ref, "ssd_scan"),
              tol_ratio(h, h_ref, "ssd_scan"))
    assert min(ratios) > 15.0, ratios
