"""The operand plan of the bfloat16 SSD backward kernels
(``csrc/ssd_scan_bwd.cu``), emulated in plain torch on the CPU and held
against the plain backward ``ssd_scan_bwd_ref``: every float32 operand of
a tensor-core product is split into bf16 hi + lo (``tc::split``), each
product of two float32 operands taken as hi*hi + hi*lo + lo*hi and of a
float32 with a bf16 operand as hi*b + lo*b, the sums kept in float32.
The emulation follows the kernels' dataflow: the chunk states S_c =
(x w)^T B and their gradients' parts U_c = (dy e)^T C, the pass over
chunks in float32 that leaves the states H and gradients G as hi/lo
planes, the row kernel (s = C B^T, dy x^T, the heads' summed Pm times B
and its transpose times C, dy H and x G), the column kernel ((s o L)^T dy
and B G^T) and the finish (the chunk's reversed sum of dcum, ddt, dA).

x and dy are bf16 as the training path gives them, at a small cut of
mamba2-2.7b (heads of 64, state 128, chunk 256; 4 heads) and of Zamba2
(state 64), with the model's decays.  Tolerance: relative L2 within 2^-8
for each of dx, ddt, dA, dB and dC, chip_smoke's ``BWD_BF16_REL_L2``; the
plan itself loses about 2^-16 of each operand, and dx is rounded to bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

BWD_BF16_REL_L2 = 2.0 ** -8
BF16 = torch.bfloat16


def _split(a):
    """bf16 hi and lo of a float32 tensor, as float32 values."""
    hi = a.to(BF16).float()
    return hi, (a - hi).to(BF16).float()


def _mm3(a, b):
    """a @ b with both operands float32: hi*hi + hi*lo + lo*hi."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _mm2(a, b):
    """a @ b with a float32 and b bf16-exact: hi*b + lo*b."""
    ah, al = _split(a)
    return ah @ b + al @ b


def _plan_bwd(x, dt, A, B, C, dy, dstate, chunk):
    """(dx, ddt, dA, dB, dC) by the kernels' plan; x and dy bfloat16."""
    b, S, nh, hp = x.shape
    st = B.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xf = x.float().reshape(b, nc, Q, nh, hp).permute(0, 1, 3, 2, 4)
    dyf = dy.float().reshape(b, nc, Q, nh, hp).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(b, nc, Q, nh).permute(0, 1, 3, 2)      # (b,nc,nh,Q)
    Bc = B.reshape(b, nc, Q, st)[:, :, None]                 # (b,nc,1,Q,st)
    Cc = C.reshape(b, nc, Q, st)[:, :, None]

    # 1. the chunk states: cum in order, S_c = (x w)^T B, U_c = (dy e)^T C
    cum = torch.cumsum(dtc * A[:, None], dim=-1)
    T = cum[..., -1]
    w = torch.exp(T[..., None] - cum) * dtc
    e = torch.exp(cum)
    S_c = _mm3((xf * w[..., None]).transpose(-1, -2), Bc)
    U_c = _mm3((dyf * e[..., None]).transpose(-1, -2), Cc)

    # 2. the pass over chunks in float32, H and G left as hi/lo planes
    h = torch.zeros(b, nh, hp, st)
    g = (dstate if dstate is not None else torch.zeros(b, nh, hp, st))
    Hs, Gs = [None] * nc, [None] * nc
    for c in range(nc):
        Hs[c] = h
        h = h * torch.exp(T[:, c])[..., None, None] + S_c[:, c]
    for c in reversed(range(nc)):
        Gs[c] = g
        g = g * torch.exp(T[:, c])[..., None, None] + U_c[:, c]
    H = torch.stack(Hs, 1)
    G = torch.stack(Gs, 1)
    Hh, Hl = _split(H)
    Gh, Gl = _split(G)

    # 3. rows: s, Pm summed over heads, dC, dB's Pm part, dy H and x G
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    s = _mm3(Cc, Bc.transpose(-1, -2))                        # (b,nc,1,Q,Q)
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, -1e30)
    L = torch.exp(seg).masked_fill(~tril, 0.0)
    dyx = dyf @ xf.transpose(-1, -2)
    Pm = L * dtc[..., None, :] * dyx
    sp = s * Pm
    dcum = sp.sum(-1) - sp.sum(-2)
    Pm_sum = Pm.sum(2, keepdim=True)
    v = dyf @ Hh + dyf @ Hl                                   # dy H
    C_f = sum(_split(Cc))
    dC = (_mm3(Pm_sum, Bc) + (e[..., None] * v).sum(2, keepdim=True))
    dcum = dcum + e * (C_f * v).sum(-1)
    xg = xf @ Gh + xf @ Gl                                    # x G
    dB = (_mm3(Pm_sum.transpose(-1, -2), Cc)
          + (w[..., None] * xg).sum(2, keepdim=True))

    # 4. columns: r = (s o L)^T dy + exp(T - cum) G B, dx, x . r
    r = _mm2((s * L).transpose(-1, -2), dyf)
    gb = _mm3(Bc, G.transpose(-1, -2))                        # B G^T
    r = r + torch.exp(T[..., None] - cum)[..., None] * gb
    xgb = (xf * gb).sum(-1)
    dcum = dcum - w * xgb
    dT = (w * xgb).sum(-1)
    dx = (dtc[..., None] * r).to(BF16)
    ddt = (xf * r).sum(-1)

    # 5. finish: dT and <G, H> at the chunk's last step, the reversed sum
    gh = ((Gh + Gl) * (Hh + Hl)).sum((-1, -2))
    dcum[..., -1] += dT + torch.exp(T) * gh
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = ddt + A[:, None] * rev
    dA = (dtc * rev).sum((0, 1, 3))

    def rows(t):                                             # (b,nc,nh,Q,.)
        return t.permute(0, 1, 3, 2, 4).reshape(b, S, nh, -1)

    return (rows(dx), rows(ddt[..., None])[..., 0], dA,
            dB.reshape(b, S, st), dC.reshape(b, S, st))


def _inputs(b, S, nh, hp, st, seed, with_dstate):
    """As chip_smoke makes them: dt a softplus, A = -linspace(1, 16),
    x and dy bf16."""
    rng = np.random.default_rng(seed)

    def randn(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    dt = torch.nn.functional.softplus(randn((b, S, nh)))
    A = -torch.linspace(1.0, 16.0, nh)
    x = randn((b, S, nh, hp), 0.5).to(BF16)
    B, C = randn((b, S, st), 0.5), randn((b, S, st), 0.5)
    dy = randn((b, S, nh, hp), 0.5).to(BF16)
    ds = randn((b, nh, hp, st), 0.5) if with_dstate else None
    return (x, dt, A, B, C), dy, ds


@pytest.mark.parametrize("b,S,nh,hp,st,chunk", [
    (1, 512, 4, 64, 128, 256),     # mamba2-2.7b's widths, 4 heads
    (1, 512, 3, 64, 64, 256),      # Zamba2's, a head count not a multiple
    (2, 128, 3, 48, 96, 64)])      # hp < 64, st zero-filled to 128
@pytest.mark.parametrize("with_dstate", [False, True])
def test_operand_plan_stays_within_the_bf16_tolerance(b, S, nh, hp, st,
                                                      chunk, with_dstate):
    args, dy, ds = _inputs(b, S, nh, hp, st, b * S + nh + st, with_dstate)
    got = _plan_bwd(*args, dy, ds, chunk)
    want = SSD.ssd_scan_bwd_ref(*args, dy, ds, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), name
        rel = float((g - w).norm() / w.norm())
        assert rel <= BWD_BF16_REL_L2, (name, rel)

