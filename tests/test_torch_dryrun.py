"""The dry run (``repro_torch.launch.dryrun``, ``launch.cost_analysis``)
on the CPU: a step counted on the ``meta`` device against the same step
counted on CPU tensors, the port's product FLOPs against the reference's
compiled HLO, the cells' argument bytes against the reference's
``jax.eval_shape`` trees, the kernels' cost functions against the bound
column of PERF.md section 6, and full-size cells that allocate nothing.

Meta against CPU: on CPU tensors the model kernels run their plain
versions, so the CPU count swaps them for stand-ins that run the plain
version with the count paused and report the kernel's own work, as the
meta branch does where the card would launch; the route around each
kernel (its autograd ``Function``, the ``contiguous`` of a gradient) is
the card's.  Every byte, FLOP and op category outside ``kernel`` is then
equal, but for the MoE dispatch's gather and scatter, which the meta run
counts at their upper bound (every one of min(T * k, E * C) slots
filled: equal when no pair is dropped, more when some are).

Against the reference (``HloAnalyzer`` counting ``dot`` and
``convolution`` FLOPs only, while loops times their trips): the port's
CPU count of ``dot`` FLOPs, where the kernels run their plain versions
(the full S x T scores, as XLA's attention computes them), is equal for
every family and kind, with two differences found and stated:
* with one CE chunk (S <= 512) XLA drops the checkpointed chunk's
  recomputed logits product of a one-trip loop when the head is untied;
  so the train kind runs S = 1,024, two chunks, where both recompute;
* in the SSM and hybrid train steps the reference counts a few
  contraction-free ``dot_general``s of its three-operand einsums (a
  broadcast product, 2 FLOPs an element) that the port's einsums run as
  elementwise multiplies: the port's ``dot`` FLOPs are at most
  ``SSM_DOT_REL`` = 1e-3 below (0.02–0.09 % measured).
"""

import collections
import contextlib
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import (  # noqa: E402
    _disable_current_modes)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import smoke_reduce as j_smoke  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.hlo_analysis import _TRIP_RE, Costs as JCosts  # noqa: E402
from repro.launch.hlo_analysis import HloAnalyzer  # noqa: E402
from repro.models import init_decode_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_NAMES, SHAPES, ShapeConfig, applicable, get_config, smoke_reduce)
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RMS  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import cost_analysis as CA  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import (init_decode_cache, init_params,  # noqa: E402
                                layers, ssm)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

#: one arch of each family, the VL backbone among them
FAMILY_ARCHS = ["llama3.2-3b", "olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b",
                "whisper-small", "qwen2-vl-72b"]
KINDS = ["train", "prefill", "decode"]
B, S = 2, 64
#: the train kind against the reference: two CE chunks (see the docstring)
REF_TRAIN_S = 1024
SSM_DOT_REL = 1e-3
OUTSIDE = [c for c in CA.BYTE_CATS if c != "kernel"]


# ---------------------------------------------------------------------------
# the kernels on the CPU as the count sees them
# ---------------------------------------------------------------------------

def _plain(fn, *args, **kw):
    """A plain version run with the count paused, its outputs contiguous
    as the kernel's are."""
    with _disable_current_modes():
        out = fn(*args, **kw)
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return tuple(t.contiguous() for t in out)


class _Calls:
    """The stand-ins' calls, by kernel (the launches the card would
    make)."""
    def __init__(self):
        self.n = collections.Counter()

    def report(self, name, cost, dtype):
        self.n[name] += 1
        CA.kernel_cost(name, cost[0], cost[1], dtype)


def _stand_ins(calls):
    """The three wrappers' CPU stand-ins: the card's route (the autograd
    Functions under autograd, the forward alone otherwise), each launch
    a plain version run paused and a kernel_cost report."""

    def rms_fwd(x, w, eps):
        D = x.shape[-1]
        y = _plain(RMS.rmsnorm_ref, x, w, eps=eps)
        calls.report("rmsnorm", RMS.rmsnorm_cost(
            x.numel() // D, D, x.element_size(), w.element_size()), None)
        return y

    class RMSFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, eps):
            ctx.save_for_backward(x, w)
            ctx.eps = eps
            return rms_fwd(x, w, eps)

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensors
            dy = dy.contiguous()
            D = x.shape[-1]
            dx, dw = _plain(RMS.rmsnorm_bwd_ref, x, w, dy, eps=ctx.eps)
            calls.report("rmsnorm_bwd", RMS.rmsnorm_bwd_cost(
                x.numel() // D, D, x.element_size(), w.element_size()),
                None)
            return dx, dw, None

    def rmsnorm(x, w, *, eps=1e-5, block_rows=256):
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return RMSFn.apply(x, w, eps)
        return rms_fwd(x, w, eps)

    def dims(q, k):
        return (*q.shape[:3], k.shape[1], k.shape[2], q.shape[3])

    def fa_cost(q, k, causal, with_lse):
        Bq, Sq, H, T, K, hd = dims(q, k)
        return FA.flash_attention_cost(Bq, Sq, T, H, K, hd, causal,
                                       q.element_size(), with_lse)

    class FAFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            o = _plain(FA.flash_attention_ref, q, k, v, causal=causal)
            lse = _plain(FA.flash_attention_lse_ref, q, k, v, causal=causal)
            calls.report("flash_attention", fa_cost(q, k, causal, True),
                         q.dtype)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            do = do.contiguous()
            grads = _plain(FA.flash_attention_bwd_ref, q, k, v, o, do,
                           causal=ctx.causal)
            Bq, Sq, H, T, K, hd = dims(q, k)
            calls.report("flash_attention_bwd", FA.flash_attention_bwd_cost(
                Bq, Sq, T, H, K, hd, ctx.causal, q.element_size()), q.dtype)
            return (*grads, None)

    def flash_attention(q, k, v, *, causal=True, block_q=256,
                        block_kv=512):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FAFn.apply(q, k, v, causal)
        o = _plain(FA.flash_attention_ref, q, k, v, causal=causal)
        calls.report("flash_attention", fa_cost(q, k, causal, False),
                     q.dtype)
        return o

    def ssd_cost(fn, x, B_, chunk):
        b, Sx, nh, hp = x.shape
        return fn(b, Sx, nh, hp, B_.shape[-1], min(chunk, Sx),
                  x.element_size())

    def ssd_fwd(x, dt, A, B_, C, chunk):
        out = _plain(SSD.ssd_scan_ref, x, dt, A, B_, C, chunk=chunk)
        calls.report("ssd_scan", ssd_cost(SSD.ssd_scan_cost, x, B_, chunk),
                     x.dtype)
        return out

    class SSDFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, B_, C, chunk):
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(x, dt, A, B_, C)
            ctx.chunk = chunk
            return ssd_fwd(x, dt, A, B_, C, chunk)

        @staticmethod
        def backward(ctx, dy, dstate):
            x, dt, A, B_, C = ctx.saved_tensors
            dy = torch.zeros_like(x) if dy is None else dy.contiguous()
            if dstate is not None:
                dstate = dstate.contiguous()
            grads = _plain(SSD.ssd_scan_bwd_ref, x, dt, A, B_, C, dy, dstate,
                           chunk=ctx.chunk)
            calls.report("ssd_scan_bwd", ssd_cost(SSD.ssd_scan_bwd_cost, x,
                                                  B_, ctx.chunk), x.dtype)
            return (*grads, None)

    def ssd_scan(x, dt, A, B_, C, *, chunk=256, head_block=8):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x, dt, A, B_, C)):
            return SSDFn.apply(x, dt, A, B_, C, chunk)
        return ssd_fwd(x, dt, A, B_, C, chunk)

    return rmsnorm, flash_attention, ssd_scan


@contextlib.contextmanager
def counted_kernels():
    """The model modules' kernels swapped for their CPU stand-ins while
    open; yields the calls."""
    calls = _Calls()
    rms, fa, ssd = _stand_ins(calls)
    swaps = [(layers, "rmsnorm", rms), (layers, "flash_attention", fa),
             (ssm, "rmsnorm", rms), (ssm, "ssd_scan", ssd)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield calls
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


# ---------------------------------------------------------------------------
# one step on the CPU and on meta
# ---------------------------------------------------------------------------

def _batch(cfg, kind, Bn=B, Sn=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (Bn, Sn)).astype(np.int32)
    out = {"tokens": toks}
    if kind == "train":
        out["labels"] = toks
    if cfg.family == "encdec":
        out["embeds"] = rng.standard_normal(
            (Bn, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def cpu_step(cfg, kind, Bn=B, Sn=S):
    """The step of ``kind`` and its arguments on CPU tensors, the inputs
    from a numpy seed (decode: from a zero cache of Sn positions)."""
    params = init_params(cfg, 0, device="cpu")
    if kind == "decode":
        cache = init_decode_cache(cfg, Bn, Sn, device="cpu")
        token = torch.from_numpy(_batch(cfg, kind, Bn, 1)["tokens"][:, 0])
        return TS.make_serve_step(cfg), (params, cache, token)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, kind, Bn, Sn).items()}
    if kind == "prefill":
        return TS.make_prefill_step(cfg), (params, batch)
    opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
    return (TS.make_train_step(cfg, opt_cfg),
            (params, adamw_init(params, opt_cfg), batch))


def count(step, args):
    with CA.CostCounter(DR._leaves(args)) as c:
        out = step(*args)
    return c, out


def _shapes(tree):
    return [(tuple(t.shape), t.dtype) for t in DR._leaves(tree)]


def smoke(arch, **kw):
    return dataclasses.replace(smoke_reduce(get_config(arch)), **kw)


def meta_and_cpu(cfg, kind):
    """(meta counter, meta output, CPU counter, CPU output, the CPU
    stand-ins' calls) of one smoke step."""
    step, args = DR.cell_step(cfg, ShapeConfig(kind, kind, S, B))
    meta, meta_out = count(step, args)
    with counted_kernels() as calls:
        cpu, cpu_out = count(*cpu_step(cfg, kind))
    return meta, meta_out, cpu, cpu_out, calls


def assert_same_outside_kernels(meta, cpu, moe_bound=False):
    for cat in OUTSIDE:
        if moe_bound and cat == "data_movement":
            assert meta.costs.bytes_by[cat] >= cpu.costs.bytes_by[cat]
        else:
            assert meta.costs.bytes_by[cat] == cpu.costs.bytes_by[cat], cat
        assert meta.costs.flops_by[cat] == cpu.costs.flops_by[cat], cat
        assert meta.costs.ops_by[cat] == cpu.costs.ops_by[cat], cat


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_count_equals_cpu_count(arch, kind):
    """Every category outside the kernels equal between the meta and the
    CPU count of one smoke step (the MoE's gather bytes at their upper
    bound on meta); each kernel's launches on meta equal its calls on the
    CPU, and its FLOPs and bytes too; every output of the meta step has
    the shape and dtype of the CPU step's."""
    cfg = smoke(arch)
    meta, meta_out, cpu, cpu_out, calls = meta_and_cpu(cfg, kind)
    assert_same_outside_kernels(meta, cpu, moe_bound=cfg.family == "moe")
    assert {k: v["launches"] for k, v in meta.costs.kernels.items()} \
        == dict(calls.n)
    assert meta.costs.kernels == cpu.costs.kernels
    assert _shapes(meta_out) == _shapes(cpu_out)
    assert all(t.is_meta for t in DR._leaves(meta_out))
    assert sum(calls.n.values()) > 0 or kind == "decode"


def test_moe_count_is_the_cpu_count_when_no_pair_is_dropped():
    """With a capacity that drops nothing (capacity_factor E / k: every
    expert takes all T tokens) the meta count's upper bound is the CPU's
    count, data movement included; with the config's 1.25 the smoke
    routing drops pairs, and the meta count's data movement is larger by
    at most the gathers and scatters of the dropped pairs."""
    base = smoke("olmoe-1b-7b")
    cfg = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.experts_per_token)
    meta, _, cpu, _, _ = meta_and_cpu(cfg, "train")
    assert_same_outside_kernels(meta, cpu)
    meta, _, cpu, _, _ = meta_and_cpu(base, "train")
    extra = (meta.costs.bytes_by["data_movement"]
             - cpu.costs.bytes_by["data_movement"])
    # the kept pairs' rows (D wide) move in the forward's gather, scatter
    # and index, and in the backward's index and scatter, 2x each
    row = base.d_model * 4
    pairs = base.n_layers * 2 * B * S * base.experts_per_token
    assert 0 < extra <= 5 * 2 * row * pairs


# ---------------------------------------------------------------------------
# the meta branches
# ---------------------------------------------------------------------------

def _to_meta(ts, grad=False):
    return [t.detach().to("meta").requires_grad_(grad) for t in ts]


def _launches():
    return {f.__name__: f.launches
            for f in RMS.WRAPPERS + FA.WRAPPERS + SSD.WRAPPERS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_branches_give_the_plain_versions_shapes(dtype):
    """Each wrapper on meta tensors, with and without autograd: outputs
    of the plain version's shapes and dtypes (the gradients, the
    forward's lse and the SSD state included), one launch counted a call
    by the wrapper and by the open count."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)

    f32 = torch.float32
    cases = [
        ("rmsnorm", RMS.rmsnorm, RMS.rmsnorm_ref, (rand(3, 5, 64), rand(64))),
        ("flash_attention",
         lambda *a: FA.flash_attention(*a, causal=False),
         lambda *a: FA.flash_attention_ref(*a, causal=False),
         (rand(2, 48, 4, 32), rand(2, 40, 2, 32), rand(2, 40, 2, 32))),
        ("ssd_scan", lambda *a: SSD.ssd_scan(*a, chunk=32),
         lambda *a: SSD.ssd_scan_ref(*a, chunk=32),
         (rand(2, 64, 4, 16), rand(2, 64, 4, dt=f32).abs(),
          -rand(4, dt=f32).abs(), rand(2, 64, 16, dt=f32),
          rand(2, 64, 16, dt=f32))),
    ]
    for name, fn, ref, args in cases:
        want = ref(*args)
        for grad in (False, True):
            margs = _to_meta(args, grad)
            before = _launches()
            with CA.CostCounter(margs) as c:
                got = fn(*margs)
                outs = list(got) if isinstance(got, tuple) else [got]
                if grad:
                    torch.autograd.backward(outs[0],
                                            torch.ones_like(outs[0]))
            after = _launches()
            assert _shapes(outs) == _shapes(want)
            names = [name, name + "_bwd"] if grad else [name]
            for n in names:
                assert c.costs.kernels[n]["launches"] == 1
                assert after[n] == before[n] + 1
            if grad:
                assert _shapes([t.grad for t in margs]) == _shapes(margs)
    q, k, v = cases[1][3]
    assert _shapes(FA.flash_attention_lse(*_to_meta((q, k, v)))) == \
        _shapes(FA.flash_attention_lse(q, k, v))


def test_a_meta_tensor_never_reaches_the_card(monkeypatch):
    """A meta step (the hybrid family's train step: every model kernel
    and its backward) never loads a library nor launches: ``launch`` and
    ``build.load`` raise if called; and a kernel's meta branch outside a
    count still counts its launch and reports to nothing."""
    from repro_torch.kernels import build, common

    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached the CUDA path")
    for mod in (common, RMS, FA, SSD):
        monkeypatch.setattr(mod, "launch", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(common, "cuda_device", refuse)
    rec = DR.run_cell("zamba2-7b", "train", cfg=smoke("zamba2-7b"),
                      shape=ShapeConfig("train", "train", S, B))
    assert set(rec["kernels"]) == {"rmsnorm", "rmsnorm_bwd", "ssd_scan",
                                   "ssd_scan_bwd", "flash_attention",
                                   "flash_attention_bwd"}
    n = RMS.rmsnorm.launches
    x = torch.empty(4, 8, device="meta")
    assert RMS.rmsnorm(x, torch.empty(8, device="meta")).is_meta
    assert RMS.rmsnorm.launches == n + 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        common.cuda_device("x", x)


# ---------------------------------------------------------------------------
# against the reference's HLO
# ---------------------------------------------------------------------------

class DotFlops(HloAnalyzer):
    """The reference's analyzer keeping ``dot`` and ``convolution`` FLOPs
    alone: while bodies times their trip counts, calls, conditionals and
    fusions recursed into."""

    def cost(self, comp=None, stack=()):
        comp = comp or self.entry
        if comp in self._cost_cache:
            return self._cost_cache[comp]
        total = JCosts()
        if comp in stack:
            return total
        for ins in self.comps.get(comp, []):
            if ins.op == "while":
                mb = re.search(r"body=%?([\w\.\-]+)", ins.line)
                mt = _TRIP_RE.search(ins.line)
                trips = int(mt.group(1)) if mt else self._cond_trips(ins)
                total += self.cost(mb.group(1), stack + (comp,)).scaled(trips)
            elif ins.op in ("call", "conditional", "custom-call",
                            "async-start", "fusion"):
                for m in re.finditer(r"(?:to_apply=|calls=|"
                                     r"branch_computations=\{)"
                                     r"%?([\w\.\-]+)", ins.line):
                    total += self.cost(m.group(1), stack + (comp,))
            elif ins.op in ("dot", "convolution"):
                total.flops += self._dot_flops(comp, ins)
        self._cost_cache[comp] = total
        return total


def reference_dot_flops(arch, kind, Sn):
    cfg = j_smoke(j_get_config(arch))
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in _batch(cfg, kind, B, Sn).items()}
    if kind == "train":
        opt_cfg = JAdamWConfig(moment_dtype=cfg.moment_dtype)
        lowered = jax.jit(JS.make_train_step(cfg, opt_cfg)).lower(
            params, j_adamw_init(params, opt_cfg), b)
    elif kind == "prefill":
        lowered = jax.jit(JS.make_prefill_step(cfg)).lower(params, b)
    else:
        lowered = jax.jit(JS.make_serve_step(cfg)).lower(
            params, j_init_cache(cfg, B, Sn), b["tokens"][:, 0])
    return DotFlops(lowered.compile().as_text(), 1).cost().flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_product_flops_match_the_reference_hlo(arch, kind):
    """The port's ``dot`` FLOPs on the CPU (plain versions counted as
    ops) against the reference's compiled step's ``dot`` FLOPs: equal,
    but the SSM families' train step within SSM_DOT_REL below (the
    module docstring says why)."""
    Sn = REF_TRAIN_S if kind == "train" else S
    cfg = smoke(arch)
    c, _ = count(*cpu_step(cfg, kind, B, Sn))
    port = c.costs.flops_by["dot"]
    ref = reference_dot_flops(arch, kind, Sn)
    assert port > 0
    if kind == "train" and cfg.family in ("ssm", "hybrid"):
        assert ref * (1 - SSM_DOT_REL) <= port < ref
    else:
        assert port == ref


# ---------------------------------------------------------------------------
# full size
# ---------------------------------------------------------------------------

CELLS = [pytest.param(arch, name, id=f"{arch}-{name}")
         for arch in ARCH_NAMES for name in SHAPES
         if applicable(get_config(arch), SHAPES[name])[0]]


def _ref_bytes(tree):
    return sum(int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


def test_argument_bytes_equal_the_reference_eval_shape_bytes():
    """Every applicable cell at full size: the parameters (with the AdamW
    state for the train kind) and the inputs (decode: the cache and the
    token), in bytes, equal to the reference's ``jax.eval_shape``
    trees'."""
    seen = {}
    for p in CELLS:
        arch, name = p.values
        jcfg, shape = j_get_config(arch), J_SHAPES[name]
        if arch not in seen:
            jopt = JS.opt_shape(jcfg, JAdamWConfig(
                moment_dtype=jcfg.moment_dtype))
            seen[arch] = (_ref_bytes(JS.params_shape(jcfg)),
                          _ref_bytes(jopt), TS.params_shape(get_config(arch)))
        params, opt, stand_ins = seen[arch]
        want = (params + _ref_bytes(JS.input_specs(jcfg, shape))
                + (opt if shape.kind == "train" else 0))
        assert DR.argument_bytes(get_config(arch), SHAPES[name],
                                 stand_ins) == want, (arch, name)


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


FULL = [("llama3.2-3b", "train_4k"), ("grok-1-314b", "train_4k"),
        ("mamba2-2.7b", "train_4k"), ("zamba2-7b", "train_4k"),
        ("whisper-small", "train_4k"), ("llama3.2-3b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", FULL)
def test_full_size_cells_allocate_nothing(arch, shape, capsys):
    """One arch a family at full width and depth, train_4k (the
    reference's 256 x 4,096 tokens on one device), and a prefill_32k:
    the record has the reference's keys and the port's, every kernel of
    the family launched, the counted peak far above any host's memory
    while the process grows by under 2 GB (nothing was allocated); its
    count wall is printed."""
    rss = _rss_bytes()
    rec = DR.run_cell(arch, shape)
    assert _rss_bytes() - rss < 2e9
    for key in ("arch", "shape", "devices", "flops_per_device",
                "bytes_per_device", "memory", "bytes_by_category",
                "collective_wire_bytes_per_device", "collective_total",
                "n_params", "active_params", "count_s", "kernels",
                "bound_s", "fits_80gb", "mesh"):
        assert key in rec, key
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] == DR.argument_bytes(get_config(arch),
                                                      SHAPES[shape])
    assert rec["collective_total"] == 0 and rec["devices"] == 1
    assert not rec["fits_80gb"] and mem["peak_bytes"] > 100e9
    family = get_config(arch).family
    want = {"flash_attention"} if family != "ssm" else set()
    if family != "encdec":
        want.add("rmsnorm")
    if family in ("ssm", "hybrid"):
        want.add("ssd_scan")
    if SHAPES[shape].kind == "train":
        want |= {k + "_bwd" for k in want}
    assert set(rec["kernels"]) == want
    b = rec["bound_s"]
    assert b["op_sum_s"] >= max(b["compute_s"], b["memory_s"]) > 0
    with capsys.disabled():
        print(f"\n{arch} {shape}: count_s {rec['count_s']:.2f}")


def test_dryrun_main_writes_one_record_a_cell(tmp_path, capsys):
    """``main`` with one cell and with a skipped one: a JSON line each,
    the ``--out`` file, ``skipped`` with the reference's reason."""
    out = tmp_path / "d.json"
    DR.main(["--arch", "whisper-small", "--shape", "decode_32k",
             "--out", str(out)])
    DR.main(["--arch", "llama3.2-3b", "--shape", "long_500k"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["shape"] for r in lines] == ["decode_32k", "long_500k"]
    assert json.loads(out.read_text()) == lines[:1]
    assert lines[1]["skipped"].startswith("long_500k skipped")
    assert lines[0]["kernels"]["flash_attention"]["launches"] == 12


def test_olmoe_tuned_plan_groups_the_dispatch():
    """``TUNED_PLANS``: olmoe's named cells take 16 MoE groups, an
    override keeps the caller's."""
    assert DR.TUNED_PLANS[("olmoe-1b-7b", "train_4k")] == {"moe_groups": 16}
    rec = DR.run_cell("olmoe-1b-7b", "x", cfg=smoke("olmoe-1b-7b"),
                      shape=ShapeConfig("x", "prefill", S, B))
    assert rec["moe_groups"] == 1 and "upper bound" in rec["moe_gather"]


# ---------------------------------------------------------------------------
# the kernels' cost functions against PERF.md section 6's bounds
# ---------------------------------------------------------------------------

def _bound_ms(cost, rate):
    return max(cost[1] / CA.HBM_BYTES_PER_S,
               cost[0] / rate) * 1e3


BF16, F32 = CA.BF16_OPS_PER_S, CA.F32_OPS_PER_S
#: (name, cost, ops rate, PERF.md section 6's bound in ms) at the
#: recorded shapes
PERF_BOUNDS = [
    ("rmsnorm prefill", RMS.rmsnorm_cost(8 * 2048, 7168, 2, 2), F32, 0.1402),
    ("rmsnorm training", RMS.rmsnorm_cost(8192, 3072, 2, 2), F32, 0.0301),
    ("rmsnorm decode", RMS.rmsnorm_cost(8, 7168, 2, 2), F32, 7.3e-05),
    ("rmsnorm qk-norm", RMS.rmsnorm_cost(1048576, 128, 2, 2), F32, 0.1603),
    ("rmsnorm mamba2", RMS.rmsnorm_cost(16384, 5120, 2, 2), F32, 0.1002),
    ("rmsnorm_bwd training", RMS.rmsnorm_bwd_cost(8192, 3072, 2, 2), F32,
     0.0451),
    ("rmsnorm_bwd olmoe", RMS.rmsnorm_bwd_cost(65536, 128, 2, 2), F32,
     0.0150),
    ("flash zamba2 prefill",
     FA.flash_attention_cost(8, 2048, 2048, 32, 32, 112, True, 2), BF16,
     0.2433),
    ("flash training",
     FA.flash_attention_cost(4, 2048, 2048, 24, 8, 128, True, 2), BF16,
     0.1043),
    ("flash qwen3 prefill",
     FA.flash_attention_cost(8, 2048, 2048, 64, 8, 128, True, 2), BF16,
     0.5561),
    ("flash whisper encoder",
     FA.flash_attention_cost(8, 1500, 1500, 12, 12, 64, False, 2), BF16,
     0.0559),
    ("flash whisper training encoder",
     FA.flash_attention_cost(16, 1500, 1500, 12, 12, 64, False, 2, True),
     BF16, 0.1118),
    ("flash_bwd training",
     FA.flash_attention_bwd_cost(4, 2048, 2048, 24, 8, 128, True, 2), BF16,
     0.2607),
    ("flash_bwd zamba2",
     FA.flash_attention_bwd_cost(4, 2048, 2048, 32, 32, 112, True, 2), BF16,
     0.3041),
    ("flash_bwd olmoe",
     FA.flash_attention_bwd_cost(4, 1024, 1024, 16, 16, 128, True, 2), BF16,
     0.0435),
    ("flash_bwd whisper cross",
     FA.flash_attention_bwd_cost(16, 448, 1500, 12, 12, 64, False, 2), BF16,
     0.0835),
    ("flash_bwd whisper decoder",
     FA.flash_attention_bwd_cost(16, 448, 448, 12, 12, 64, True, 2), BF16,
     0.0263),
    ("ssd_scan zamba2", SSD.ssd_scan_cost(8, 2048, 112, 64, 64, 256, 2),
     BF16, 0.1493),
    ("ssd_scan mamba2", SSD.ssd_scan_cost(8, 2048, 80, 64, 128, 256, 2),
     BF16, 0.1130),
    ("ssd_scan_bwd mamba2",
     SSD.ssd_scan_bwd_cost(4, 2048, 80, 64, 128, 256, 2), BF16, 0.0817),
    ("ssd_scan_bwd zamba2",
     SSD.ssd_scan_bwd_cost(4, 2048, 112, 64, 64, 256, 2), BF16, 0.1099),
]


@pytest.mark.parametrize("name,cost,rate,want",
                         PERF_BOUNDS, ids=[p[0] for p in PERF_BOUNDS])
def test_kernel_costs_reproduce_the_recorded_bounds(name, cost, rate, want):
    assert _bound_ms(cost, rate) == pytest.approx(want, rel=0.01)
