"""dA of the float32 SSD backward kernels (``csrc/ssd_scan_bwd.cu``, the
float32-x path) by their precision plan, emulated in plain torch on the
CPU and held against the exact gradient (``ssd_scan_bwd_ref`` in float64).

Per (batch, chunk, head) the kernels form dA = sum_j dt_j sum_{i>=j}
dcum_i, where dcum_i is the rows' sum less the columns' sum of s o Pm
(s_ij = C_i . B_j, Pm_ij = L_ij dt_j dy_i . x_j, L_ij = exp(cum_i -
cum_j)) plus the carried state's terms.  The plan: cum summed in float64
and each exponent formed in float64; each s o Pm term and each state
term's dot product in float32; the rows' and columns' sums, dcum and its
reversed sums in float64.  Inputs as chip_smoke.py's [20a] makes them (A
= -linspace(1, 16), dt a softplus of a normal), where cum reaches
~-2,600 in a chunk of 256 and dA is a small difference of large sums.
Tolerance: 1e-4 of dA's largest magnitude, the forward's float32
tolerance, against which the kernels are held on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

F32_TOL = 1e-4
f32, f64 = torch.float32, torch.float64


def _randn(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def _inputs(b, S, nh, hp, st, seed, with_dstate):
    dt = torch.nn.functional.softplus(_randn((b, S, nh), seed))
    A = -torch.linspace(1.0, 16.0, nh)
    dstate = (_randn((b, nh, hp, st), seed + 5, 0.5) if with_dstate
              else None)
    return (_randn((b, S, nh, hp), seed + 1, 0.5), dt, A,
            _randn((b, S, st), seed + 2, 0.5),
            _randn((b, S, st), seed + 3, 0.5),
            _randn((b, S, nh, hp), seed + 4, 0.5), dstate)


def _plan_dA(x, dt, A, B, C, dy, dstate, Q):
    """dA by the kernels' precision plan (float64 values rounded to
    float32 where the kernels hold float32)."""
    b, S, nh, hp = x.shape
    st = B.shape[-1]
    nc = S // Q
    x, dt, A, B, C, dy = (t.to(f64) for t in (x, dt, A, B, C, dy))
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    r32 = lambda t: t.to(f32).to(f64)  # noqa: E731
    dA = torch.zeros(nh, dtype=f64)
    for bi in range(b):
        cums, own, grad_part = [], [], []
        for c in range(nc):
            sl = slice(c * Q, (c + 1) * Q)
            cum = torch.cumsum(dt[bi, sl] * A, 0)                 # (Q, nh)
            w = torch.exp(cum[-1] - cum) * dt[bi, sl]
            own.append(torch.einsum("jh,jhp,js->hps", w, x[bi, sl],
                                    B[bi, sl]))
            grad_part.append(torch.einsum("ih,ihp,is->hps", torch.exp(cum),
                                          dy[bi, sl], C[bi, sl]))
            cums.append(cum)
        H = [torch.zeros(nh, hp, st, dtype=f64)]
        for c in range(nc - 1):
            H.append(H[-1] * torch.exp(cums[c][-1])[:, None, None] + own[c])
        G = [None] * nc
        g = (torch.zeros(nh, hp, st, dtype=f64) if dstate is None
             else dstate[bi].to(f64))
        for c in reversed(range(nc)):
            G[c] = g
            g = g * torch.exp(cums[c][-1])[:, None, None] + grad_part[c]
        for c in range(nc):
            sl = slice(c * Q, (c + 1) * Q)
            s = C[bi, sl] @ B[bi, sl].T
            for h in range(nh):
                ch = cums[c][:, h]
                seg = (ch[:, None] - ch[None, :]).masked_fill(~tril,
                                                              -float("inf"))
                L = r32(torch.exp(r32(seg)))
                dyx = r32(dy[bi, sl, h] @ x[bi, sl, h].T)
                pp = r32(r32(s) * r32(L * dt[bi, sl, h][None, :] * dyx))
                dcum = pp.sum(1) - pp.sum(0)
                e = r32(torch.exp(r32(ch)))
                v = r32(dy[bi, sl, h] @ H[c][h])
                dcum = dcum + e * r32((C[bi, sl] * v).sum(1))
                W = r32(torch.exp(r32(ch[-1] - ch)) * dt[bi, sl, h])
                gb = r32(B[bi, sl] @ G[c][h].T)
                dW = W * r32((x[bi, sl, h] * gb).sum(1))
                dcum = dcum - dW
                dcum[-1] += (dW.sum() + r32(torch.exp(r32(ch[-1])))
                             * r32((G[c][h] * H[c][h]).sum()))
                rev = torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0), [0])
                dA[h] += (rev * dt[bi, sl, h]).sum()
    return dA


@pytest.mark.parametrize("b,S,nh,hp,st,chunk,seed", [
    (1, 512, 7, 64, 128, 256, 230),    # 7 heads, state 128
    (1, 256, 4, 64, 128, 256, 220),    # one chunk
    (2, 256, 4, 64, 64, 64, 210)])     # state 64, four chunks a sequence
@pytest.mark.parametrize("with_dstate", [False, True])
def test_float32_plan_keeps_dA_within_the_tolerance(b, S, nh, hp, st, chunk,
                                                     seed, with_dstate):
    x, dt, A, B, C, dy, dstate = _inputs(b, S, nh, hp, st, seed, with_dstate)
    exact = SSD.ssd_scan_bwd_ref(
        x.double(), dt.double(), A.double(), B.double(), C.double(),
        dy.double(), None if dstate is None else dstate.double(),
        chunk=chunk)[2]
    got = _plan_dA(x, dt, A, B, C, dy, dstate, chunk)
    err = float((got - exact).abs().max() / exact.abs().max())
    assert err <= F32_TOL, err
