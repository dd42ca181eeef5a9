"""Port kernels (repro_torch) against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that plain version against the JAX ``ref.py`` body and against the Pallas
kernel in interpret mode, on the same seeded numpy inputs. Tests marked
``cuda`` hold the hand-written CUDA kernels against the plain versions on
the card and skip where there is none.

Stated tolerances: RMSNorm f32 rtol 1e-6/atol 1e-6 (same formula, sums in
another order); bf16 one bf16 ulp (the f32 results may straddle a rounding
boundary); its backward (the autograd Function on its plain path) against
``jax.grad`` of the reference the same. Flash attention (K6), as
max|port − JAX| / max|JAX|: forward f32 1e-5 and the gradient (against
``jax.vjp`` of ``chunked_mha``) f32 1e-5 (sums in other orders; observed
≤ 2e-6); forward bf16 2^-7 (the plain version rounds p to bf16 before P·V
as the Pallas body does, the exact reference does not, and interpret mode
also rounds each 128-key block's P·V to bf16; observed ≤ 4.2e-3) and the
bf16 gradient 2^-5 (the port's Δ = rowsum(dO∘O) reads the bf16-rounded
output, as FlashAttention-2 does, while JAX differentiates its f32
recompute, and dS = p∘(dP − Δ) cancels; observed ≤ 1.7e-2). Paged append: bitwise. Paged attend f32 2e-6 (the reference's
own kernel tolerance: online vs two-pass softmax). Optimizer steps (K1, K2)
and fused boundaries (K3, K4): f32 within 2 ulp (XLA's CPU fusion may
contract or reorder the reference's ops), bf16 equal or 1 bf16 ulp (XLA may
keep an f32 intermediate where the reference rounds to bf16). The plain
pullback (K5): bitwise against the reference's ``ref.py``, and within one
ulp of max(|x|, |z|) of the Pallas kernel in interpret mode (which
contracts ``a*b + c``). On the card the kernels equal their plain versions
bit for bit (same rounding points, same worker-sum order), except the
consensus probe (K8, and the probe output of K3/K4), whose two sums the
kernel adds in float64 over its grid: within rtol 1e-6 of the plain
version; the fused output equals K8's bit for bit, and K8 gives the same
bits on every run. The probe's CPU tests against the JAX package are in
``tests/test_torch_control.py``; the WKV's (K12), in
``tests/test_torch_rwkv6.py``. On the card K12 and its backward kernel are
held against the plain ``wkv_chunked`` and its torch autograd (f32 2e-5 for
y and the state, 1e-4 for the gradients; bf16 2^-7 and 2^-5), K6 also at
head_dim 80 and at zamba2's shared block (its bf16 kernels run on the
tensor cores and round P and dS to bf16, within the same bounds; the split
of its dK/dV pass over a GQA group is pinned on the CPU), K9 also at a GQA
group of 12 and at head_dim 80. K11 and its
backward kernel are held against the plain ``ssd_chunked`` and its torch
autograd (f32 2e-5 for y and the state, 1e-4 for the gradients; bf16 x/B/C
2^-7 for dx, dB, dC); their CPU tests against the JAX package are in
``tests/test_torch_zamba2.py``.
"""
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import all_kernels
from repro_torch.kernels.anchor_mix import ops as am_ops
from repro_torch.kernels.anchor_mix import ref as am_ref
from repro_torch.kernels.consensus_probe import ops as probe_ops
from repro_torch.kernels.consensus_probe import ref as probe_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.opt_step import ops as opt_ops
from repro_torch.kernels.opt_step import ref as opt_ref
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.kernels.paged_attn import ref as pa_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference modules (imported here, not at the top, so that the
    ``cuda`` tests also run where JAX is not installed, as on the card)."""
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(
        jnp=mod("jax.numpy"),
        pa_kernel=mod("repro.kernels.paged_attn.kernel"),
        pa_ref=mod("repro.kernels.paged_attn.ref"),
        rms_kernel=mod("repro.kernels.rmsnorm.kernel"),
        rms_ref=mod("repro.kernels.rmsnorm.ref"),
        flags=mod("repro.kernels.flags"),
        opt_ops=mod("repro.kernels.opt_step.ops"),
        opt_ref=mod("repro.kernels.opt_step.ref"),
        am_ops=mod("repro.kernels.anchor_mix.ops"),
        am_ref=mod("repro.kernels.anchor_mix.ref"),
        jax=mod("jax"),
        fa_ops=mod("repro.kernels.flash_attention.ops"),
        fa_ref=mod("repro.kernels.flash_attention.ref"),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda", 0)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


# -- K7 rmsnorm ---------------------------------------------------------------


@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(dtype, against, rng, jx):
    x = rng.normal(size=(5, 384)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(384,))).astype(np.float32)
    xj, sj = jx.jnp.asarray(x, dtype), jx.jnp.asarray(scale, dtype)
    if against == "ref":
        want = jx.rms_ref.rmsnorm(xj, sj, 1e-6)
    else:
        want = jx.rms_kernel.rmsnorm_2d(xj, sj, eps=1e-6, interpret=True)
    want = np.asarray(want.astype(jx.jnp.float32))
    tdt = getattr(torch, dtype)
    got = rms_ops.rmsnorm(_t(x, tdt), _t(scale, tdt), 1e-6).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_rmsnorm_leading_dims_and_empty(rng):
    x = _t(rng.normal(size=(2, 3, 64)).astype(np.float32))
    s = _t(np.ones(64, np.float32))
    out = rms_ops.rmsnorm(x, s)
    assert out.shape == x.shape
    torch.testing.assert_close(out, rms_ref.rmsnorm(x, s), rtol=0, atol=0)
    empty = torch.zeros(0, 64)
    assert rms_ops.rmsnorm(empty, s).shape == (0, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_function_grads_match_jax(dtype, rng, jx):
    """The autograd Function (plain path here) against ``jax.vjp`` of the
    reference ``rmsnorm``: dx and dscale."""
    x = rng.normal(size=(5, 384)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(384,))).astype(np.float32)
    dy = rng.normal(size=(5, 384)).astype(np.float32)
    _, vjp = jx.jax.vjp(lambda a, b: jx.rms_ref.rmsnorm(a, b, 1e-6), jx.jnp.asarray(x, dtype), jx.jnp.asarray(scale, dtype))
    want = [np.asarray(g.astype(jx.jnp.float32)) for g in vjp(jx.jnp.asarray(dy, dtype))]
    tdt = getattr(torch, dtype)
    xt, st = _t(x, tdt).requires_grad_(True), _t(scale, tdt).requires_grad_(True)
    y = rms_ops.rmsnorm(xt, st, 1e-6)
    assert type(y.grad_fn.next_functions[0][0]).__name__.startswith("RMSNorm")
    y.backward(_t(dy, tdt))
    for got, w in zip((xt.grad, st.grad), want):
        got = got.float().numpy()
        if dtype == "float32":
            assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max()
        else:
            assert (np.abs(got - w) <= _bf16_ulp(w)).all()


def test_rmsnorm_bwd_plain_is_autograd_of_plain_forward(rng):
    x = _t(rng.normal(size=(7, 64)).astype(np.float32)).requires_grad_(True)
    s = _t((1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)).requires_grad_(True)
    dy = _t(rng.normal(size=(7, 64)).astype(np.float32))
    rms_ref.rmsnorm(x, s, 1e-5).backward(dy)
    dx, ds = rms_ops.rmsnorm_bwd(x.detach(), s.detach(), dy, eps=1e-5)
    assert torch.equal(dx, x.grad) and torch.equal(ds, s.grad)
    # no gradient wanted: the plain forward, no graph
    assert rms_ops.rmsnorm(x.detach(), s.detach()).grad_fn is None


RMS_PLAN_DS = (64, 80, 2048, 3584, 4096, 4097)
RMS_PLAN_ROWS = (1, 7, 33, 300, 65536)


@pytest.mark.parametrize("elem", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("d", RMS_PLAN_DS)
def test_rmsnorm_plan_lays_every_vector_once(d, elem):
    """The forward planner: a sub-warp (a power of two <= 32 lanes) a row up
    to d 1024, a CTA (a multiple of 32 threads, at most 512) a row above it,
    the block kernel where d is not in whole 16-byte vectors; thread i holds
    vectors i, i + lanes, ... (at most ``vecs``), which cover the row's
    vectors once each; the grid covers ragged row counts."""
    lanes, vecs = rms_ops.plan(d, elem)
    per = 16 // elem
    if d % per:
        assert (lanes, vecs) == (0, 0)
        return
    nv = d // per
    assert vecs in (1, 2, 4, 8)
    held = sorted(i + v * lanes for i in range(lanes) for v in range(vecs) if i + v * lanes < nv)
    assert held == list(range(nv))
    if d <= rms_ops.NARROW_D:
        assert lanes <= 32 and lanes & (lanes - 1) == 0
        for rows in RMS_PLAN_ROWS:
            per_cta = 256 // lanes
            ctas = -(-rows // per_cta)
            assert (ctas - 1) * per_cta < rows <= ctas * per_cta
    else:
        assert lanes % 32 == 0 and 32 < lanes <= rms_ops.WIDE_THREADS
        if elem == 2 and d in (2048, 3584, 4096):  # whole vectors a thread: 256, 448, 512 threads of one
            assert (lanes, vecs) == (d // 8, 1)
    assert d != 64 or elem != 2 or (lanes, vecs) == (8, 1)  # the group norm: 8 lanes of one vector, 32 rows a CTA


@pytest.mark.parametrize("rows", RMS_PLAN_ROWS)
@pytest.mark.parametrize("d", RMS_PLAN_DS)
def test_rmsnorm_bwd_plan_splits_rows_in_fixed_blocks(d, rows):
    """The backward planner: rows of at most 32 vectors go to the sub-warp
    kernel with a row range a multiple of its 1024 // lanes sub-warps and at
    most one block an SM; wider rows to the block kernel over at most
    ``BWD_BLOCKS`` blocks. The blocks' ranges cover every row once."""
    for elem in (2, 4):
        lanes, per_block = rms_ops.bwd_plan(rows, d, elem)
        blocks = -(-rows // per_block)
        assert (blocks - 1) * per_block < rows <= blocks * per_block
        nv = d // (16 // elem)
        if d % (16 // elem) == 0 and nv <= 32:
            assert lanes & (lanes - 1) == 0 and nv <= lanes <= 32
            assert per_block % (rms_ops.BWD_THREADS // lanes) == 0 and blocks <= rms_ops.SMS
        else:
            assert lanes == 0 and blocks <= rms_ops.BWD_BLOCKS


# -- K6 flash attention ------------------------------------------------------------

# the reference's own kernel sweep (tests/test_kernels.py): GQA, a ragged S,
# a sliding window, bidirectional, one query against a cache (q_offset); then
# S over several 128-key blocks (the plain forward's and the bf16 kernel's
# block), with qwen2's group of 7, at head_dim 128 and 80, with a window of
# 64, and 128 queries at q_offset 256
FA_CASES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 130, 130, 4, 4, 64, True, None),
    (2, 64, 64, 8, 2, 32, True, 16),
    (1, 64, 64, 2, 1, 32, False, None),
    (2, 1, 96, 4, 2, 32, True, None),
    (1, 384, 384, 14, 2, 128, True, None),
    (1, 384, 384, 14, 2, 80, True, None),
    (1, 384, 384, 14, 2, 128, True, 64),
    (1, 128, 384, 14, 2, 128, True, None),
]
FA_IDS = ["gqa", "ragged", "window", "bidir", "q_offset", "blocks", "blocks_d80", "blocks_window", "blocks_q_offset"]
FA_FWD_BOUND = {"float32": 1e-5, "bfloat16": 2.0**-7}
FA_GRAD_BOUND = {"float32": 1e-5, "bfloat16": 2.0**-5}


def _fa_case(rng, b, sq, sk, h, hkv, d):
    return [rng.normal(size=s).astype(np.float32) for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_flash_attention_plain_matches_jax(case, dtype, rng, jx):
    """The plain forward against the reference's exact softmax and against
    its Pallas kernel in interpret mode (its own public wrapper)."""
    b, sq, sk, h, hkv, d, causal, window = case
    q_off = sk - sq if sq < sk else 0
    arrays = _fa_case(rng, b, sq, sk, h, hkv, d)
    jarr = [jx.jnp.asarray(a, dtype) for a in arrays]
    tdt = getattr(torch, dtype)
    got = fa_ops.flash_attention(*[_t(a, tdt) for a in arrays], causal, window, q_off).float().numpy()
    exact = jx.fa_ref.mha_reference(*jarr, causal=causal, window=window, q_offset=q_off)
    interp = jx.fa_ops.flash_attention(*jarr, causal, window, q_off)
    for want in (exact, interp):
        assert _rel(got, np.asarray(want.astype(jx.jnp.float32))) <= FA_FWD_BOUND[dtype]
    # the port's copies of the reference's oracles
    tq, tk, tv = (_t(a) for a in arrays)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    if dtype == "float32":
        np.testing.assert_allclose(fa_ref.mha_reference(tq, tk, tv, **kw).numpy(), np.asarray(exact), rtol=1e-5,
                                   atol=1e-5)
        jchunk = jx.fa_ref.chunked_mha(*jarr, block_q=16, block_k=32, **kw)
        np.testing.assert_allclose(fa_ref.chunked_mha(tq, tk, tv, block_q=16, block_k=32, **kw).numpy(),
                                   np.asarray(jchunk), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_flash_attention_function_grads_match_jax_vjp(case, dtype, rng, jx):
    """The autograd Function (plain FlashAttention-2 backward here) against
    ``jax.vjp`` of ``chunked_mha``, the reference's own backward."""
    b, sq, sk, h, hkv, d, causal, window = case
    q_off = sk - sq if sq < sk else 0
    arrays = _fa_case(rng, b, sq, sk, h, hkv, d)
    g = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    leaves = [_t(a, tdt).requires_grad_(True) for a in arrays]
    out = fa_ops.flash_attention(*leaves, causal, window, q_off)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    out.backward(_t(g, tdt))
    _, vjp = jx.jax.vjp(lambda q, k, v: jx.fa_ref.chunked_mha(q, k, v, causal=causal, window=window, q_offset=q_off),
                        *[jx.jnp.asarray(a, dtype) for a in arrays])
    for leaf, want in zip(leaves, vjp(jx.jnp.asarray(g, dtype))):
        assert leaf.grad.dtype == tdt
        assert _rel(leaf.grad.float().numpy(), np.asarray(want.astype(jx.jnp.float32))) <= FA_GRAD_BOUND[dtype]


def test_flash_attention_plain_masks_and_empty_rows(rng):
    """sk_valid masks the padded keys (garbage there, even NaN, cannot leak);
    a row with every key masked gives a zero output, lse +inf and zero
    gradients; the backward equals torch autograd of the plain forward in
    f32."""
    q, k, v = (_t(a) for a in _fa_case(rng, 1, 8, 12, 2, 1, 16))
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:], v2[:, 10:] = float("nan"), float("nan")
    out, lse = fa_ops.flash_attention_fwd(q, k2, v2, causal=False, window=None, q_offset=0, sk_valid=10)
    want, _ = fa_ops.flash_attention_fwd(q[:, :], k[:, :10], v[:, :10], causal=False)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    # window 2 at q_offset 20 over 12 keys: every row sees nothing
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=True, window=2, q_offset=20)
    assert torch.count_nonzero(out) == 0 and bool(torch.isinf(lse).all())
    dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q), causal=True, window=2, q_offset=20)
    assert all(torch.count_nonzero(t) == 0 for t in (dq, dk, dv))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dout = _t(rng.normal(size=q.shape).astype(np.float32))
    auto = torch.autograd.grad(fa_ref.flash_attention_fwd(*leaves, causal=True, window=5)[0], leaves, dout)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=True, window=5)
    for got, want in zip(fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=5), auto):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("b, hkv, group, sk", [(2, 4, 7, 512), (1, 4, 7, 4096), (2, 8, 4, 512), (2, 2, 4, 256),
                                             (1, 2, 2, 160), (2, 32, 1, 512), (1, 1, 1, 64)])
def test_flash_attention_dkdv_splits_cover_each_q_head_once(b, hkv, group, sk):
    """The bf16 dK/dV kernel's split count n of each kv-head's group: the
    kernel gives split i the q-heads [i g / n, (i + 1) g / n), so every
    q-head is covered once and no split is empty while 1 <= n <= group; no
    split at group 1; short of one q-head a split, two CTAs for each SM;
    enough CTAs for the H100's 132 SMs at the qwen2 slice (B 2, 4 KV heads,
    group 7, S 512); never fewer splits on a larger card."""
    ctas = b * hkv * -(-sk // 128)  # one CTA per (batch, kv-head, 128 keys) and split
    for sms in (16, 132, 1024):
        n = fa_ops.dkdv_splits(b, hkv, group, sk, sms)
        assert 1 <= n <= group
        assert n == group or ctas * n >= 2 * sms
        assert n <= fa_ops.dkdv_splits(b, hkv, group, sk, 2 * sms)
        if group == 1:
            assert n == 1
    if (b, hkv, group, sk) == (2, 4, 7, 512):
        assert ctas * fa_ops.dkdv_splits(b, hkv, group, sk, 132) >= 132


@pytest.mark.parametrize("n", [2, 3, 7])
def test_flash_attention_dkdv_split_partials_sum_to_the_group(rng, n):
    """The split dK/dV pass: split i's f32 partial is the plain dK/dV over
    q-heads [i g / n, (i + 1) g / n) of each kv-head's group (the kernel's
    ranges); ``dkdv_sum`` of the partials (on the CPU, its plain version)
    adds them in split order, bit for bit as a loop does, and gives the
    whole group's dK/dV within 1e-5 of max|plain| (the sums run in other
    orders)."""
    b, sq, sk, h, hkv, d = 1, 160, 160, 14, 2, 64
    g = h // hkv
    kw = dict(causal=True, window=None, q_offset=0, sk_valid=None)
    q = _t((rng.normal(size=(b, sq, h, d)) / d**0.5).astype(np.float32))
    k, v = (_t(rng.normal(size=(b, sk, hkv, d)).astype(np.float32)) for _ in range(2))
    dout = _t(rng.normal(size=(b, sq, h, d)).astype(np.float32))
    out, lse = fa_ref.flash_attention_fwd(q, k, v, **kw)
    _, delta = fa_ref.flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw)
    want = fa_ref.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw)

    def heads(t, lo, hi):  # q-heads [lo, hi) of every group; (B, S, H, D) or (B, H, S)
        if t.dim() == 4:
            return t.reshape(b, sq, hkv, g, d)[:, :, :, lo:hi].reshape(b, sq, hkv * (hi - lo), d)
        return t.reshape(b, hkv, g, sq)[:, :, lo:hi].reshape(b, hkv * (hi - lo), sq)

    parts = [fa_ref.flash_attention_bwd_dkdv(heads(q, lo, hi), k, v, heads(dout, lo, hi), heads(lse, lo, hi),
                                             heads(delta, lo, hi), **kw)
             for lo, hi in ((i * g // n, (i + 1) * g // n) for i in range(n))]
    part = torch.stack([torch.stack([p[j] for p in parts]) for j in (0, 1)])  # (2, n, B, Sk, Hkv, D)
    got = fa_ops.dkdv_sum(part, torch.float32)
    loop = part[:, 0].clone()
    for i in range(1, n):
        loop = loop + part[:, i]
    assert torch.equal(got[0], loop[0]) and torch.equal(got[1], loop[1])
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
    bf = fa_ops.dkdv_sum(part, torch.bfloat16)
    assert all(torch.equal(x, y.to(torch.bfloat16)) for x, y in zip(bf, loop))


# -- K10 paged append ------------------------------------------------------------


def _append_case(rng, t):
    """3 slots: a live mid-page slot, an idle slot (zero table row, length 0,
    writing into trash page 0), and a slot whose positions run past the end of
    its table (clamped onto its last page)."""
    pool = rng.normal(size=(9, 8, 2, 16)).astype(np.float32)
    new = rng.normal(size=(3, t, 2, 16)).astype(np.float32)
    pt = np.asarray([[3, 5], [0, 0], [7, 8]], np.int32)
    lens = np.asarray([5, 0, 14], np.int32)
    return pool, new, pt, lens


@pytest.mark.parametrize("t", [1, 4, 11])
def test_paged_append_plain_bitwise_vs_jax_ref(t, rng, jx):
    pool, new, pt, lens = _append_case(rng, t)
    want = np.asarray(jx.pa_ref.paged_append(jx.jnp.asarray(pool), jx.jnp.asarray(new), jx.jnp.asarray(pt), jx.jnp.asarray(lens)))
    got = pa_ops.paged_append_(_t(pool), _t(new), _t(pt), _t(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_append_plain_bitwise_vs_pallas_interpret(rng, jx):
    pool, new, pt, lens = _append_case(rng, 1)
    want = jx.pa_kernel.paged_append_decode(
        jx.jnp.pad(jx.jnp.asarray(pool), ((0, 0), (0, 0), (0, 0), (0, 112))),
        jx.jnp.pad(jx.jnp.asarray(new[:, 0]), ((0, 0), (0, 0), (0, 112))),
        jx.jnp.asarray(pt), jx.jnp.asarray(lens), interpret=True,
    )[..., :16]
    got = pa_ops.paged_append_(_t(pool), _t(new), _t(pt), _t(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_append_is_in_place_and_clamps(rng):
    pool = torch.zeros(4, 4, 1, 2)
    new = torch.arange(1, 1 + 6 * 2, dtype=torch.float32).reshape(1, 6, 1, 2)
    pt = torch.tensor([[3, 1]], dtype=torch.int32)
    out = pa_ops.paged_append_(pool, new, pt, torch.tensor([4], dtype=torch.int32))
    assert out is pool
    # positions 4..9: page idx 1 (offsets 0..3), then 8, 9 clamp onto page 1 offsets 0, 1
    np.testing.assert_array_equal(pool[1, :, 0, 0].numpy(), [9, 11, 5, 7])
    assert pool[3].abs().sum() == 0 and pool[0].abs().sum() == 0


def _append_kv_case(rng, t):
    """4 slots for both pools: a live mid-page slot, two idle slots (zero
    table rows, length 0) that both write trash page 0, and a slot whose
    positions run past the end of its table (clamped onto its last page,
    where at T > 1 its own later tokens overwrite earlier ones)."""
    pools = [rng.normal(size=(9, 8, 2, 16)).astype(np.float32) for _ in range(2)]
    news = [rng.normal(size=(4, t, 2, 16)).astype(np.float32) for _ in range(2)]
    pt = np.asarray([[3, 5], [0, 0], [7, 8], [0, 0]], np.int32)
    lens = np.asarray([5, 0, 17, 0], np.int32)
    return pools, news, pt, lens


def test_paged_append_kv_plain_bitwise_vs_pallas_interpret(rng, jx):
    """T 1 (decode): both pools against the Pallas kernel in interpret mode,
    slot 3's row winning page 0 over slot 1's."""
    (pk, pv), (k, v), pt, lens = _append_kv_case(rng, 1)
    pad = ((0, 0), (0, 0), (0, 0), (0, 112))
    want = [np.asarray(jx.pa_kernel.paged_append_decode(
        jx.jnp.pad(jx.jnp.asarray(pool), pad), jx.jnp.pad(jx.jnp.asarray(new[:, 0]), pad[1:]), jx.jnp.asarray(pt),
        jx.jnp.asarray(lens), interpret=True)[..., :16]) for pool, new in ((pk, k), (pv, v))]
    got = pa_ops.paged_append_kv_(_t(pk), _t(pv), _t(k), _t(v), _t(pt), _t(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[0][0, 0].numpy(), k[3, 0])


@pytest.mark.parametrize("t", [4, 11])
def test_paged_append_kv_plain_bitwise_vs_jax_ref(t, rng, jx):
    """T > 1 (prefill chunks): both pools against JAX's plain
    ``paged_append``, with the clamped slot's and the idle slots' collisions."""
    (pk, pv), (k, v), pt, lens = _append_kv_case(rng, t)
    got = pa_ops.paged_append_kv_(_t(pk), _t(pv), _t(k), _t(v), _t(pt), _t(lens))
    for g, pool, new in zip(got, (pk, pv), (k, v)):
        want = jx.pa_ref.paged_append(*map(jx.jnp.asarray, (pool, new, pt, lens)))
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_paged_append_kv_checks(rng):
    (pk, pv), (k, v), pt, lens = _append_kv_case(rng, 1)
    pk, pv, k, v, pt, lens = map(_t, (pk, pv, k, v, pt, lens))
    with pytest.raises(ValueError, match="must match"):
        pa_ops.paged_append_kv_(pk, pv[:4], k, v, pt, lens)
    with pytest.raises(ValueError, match="must match"):
        pa_ops.paged_append_kv_(pk, pv, k, v[:, :, :1], pt, lens)
    with pytest.raises(TypeError, match="dtypes differ"):
        pa_ops.paged_append_kv_(pk, pv.double(), k, v, pt, lens)
    # a device the kernels do not run on is refused, not sent to the plain path
    meta = [t.to("meta") for t in (pk, pv, k, v, pt, lens)]
    with pytest.raises(ValueError, match="unsupported devices"):
        pa_ops.paged_append_kv_(*meta)
    with pytest.raises(ValueError, match="unsupported devices"):
        pa_ops.paged_append_(meta[0], meta[2], meta[4], meta[5])


# -- K9 paged attend -------------------------------------------------------------


def _attend_case(rng, s=3, kv=2, g=4, d=16, page=8, maxp=3):
    pool_k = rng.normal(size=(s * maxp + 1, page, kv, d)).astype(np.float32)
    pool_v = rng.normal(size=pool_k.shape).astype(np.float32)
    pt = np.arange(1, s * maxp + 1, dtype=np.int32).reshape(s, maxp)
    pt[0] = 0  # idle slot: trash page, length 0
    lens = np.asarray([0, 11, 23][:s], np.int32)
    q = rng.normal(size=(s, 1, kv * g, d)).astype(np.float32) / np.sqrt(d)
    return q, pool_k, pool_v, pt, lens


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("g", [1, 4, 7])
def test_paged_attend_decode_plain_vs_jax_ref(g, window, rng, jx):
    q, pk, pv, pt, lens = _attend_case(rng, g=g)
    want = jx.pa_ref.paged_attend_gqa(*map(jx.jnp.asarray, (q, pk, pv, pt, lens)), window=window)
    got = pa_ops.paged_attend_gqa(*map(_t, (q, pk, pv, pt, lens)), window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("window", [None, 10])
def test_paged_attend_decode_plain_vs_pallas_interpret(window, rng, jx):
    s, kv, g, d = 3, 2, 4, 16
    q, pk, pv, pt, lens = _attend_case(rng, s=s, kv=kv, g=g, d=d)
    qk = jx.jnp.pad(jx.jnp.asarray(q).reshape(s, kv, g, d), ((0, 0), (0, 0), (0, 8 - g), (0, 128 - d)))
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - d))
    want = jx.pa_kernel.paged_attend_decode(
        qk, jx.jnp.pad(jx.jnp.asarray(pk), pad), jx.jnp.pad(jx.jnp.asarray(pv), pad),
        jx.jnp.asarray(pt), jx.jnp.asarray(lens), window=window, interpret=True,
    )[:, :, :g, :d]
    got = pa_ops.paged_attend_decode(
        _t(q).reshape(s, kv, g, d), _t(pk), _t(pv), _t(pt), _t(lens), window=window
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("window", [None, 5])
def test_paged_attend_prefill_chunk_plain_vs_jax_ref(window, rng, jx):
    """T > 1 (chunked prefill) is the plain body on every device, as in the reference."""
    s, kv, g, d, page, maxp, t = 2, 2, 2, 16, 4, 4, 6
    pool_k = rng.normal(size=(s * maxp + 1, page, kv, d)).astype(np.float32)
    pool_v = rng.normal(size=pool_k.shape).astype(np.float32)
    pt = np.arange(1, s * maxp + 1, dtype=np.int32).reshape(s, maxp)
    lens = np.asarray([0, 7], np.int32)
    q = rng.normal(size=(s, t, kv * g, d)).astype(np.float32)
    want = jx.pa_ref.paged_attend_gqa(*map(jx.jnp.asarray, (q, pool_k, pool_v, pt, lens)), window=window)
    got = pa_ops.paged_attend_gqa(*map(_t, (q, pool_k, pool_v, pt, lens)), window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


def test_paged_gather_and_targets_match_jax(rng, jx):
    pool = rng.normal(size=(5, 4, 3)).astype(np.float32)
    pt = np.asarray([[2, 4], [1, 3]], np.int32)
    np.testing.assert_array_equal(
        pa_ref.paged_gather(_t(pool), _t(pt)).numpy(), np.asarray(jx.pa_ref.paged_gather(jx.jnp.asarray(pool), jx.jnp.asarray(pt)))
    )
    lens = np.asarray([6, 1], np.int32)
    want = jx.pa_ref.append_targets(jx.jnp.asarray(pt), jx.jnp.asarray(lens), 5, 4)
    got = pa_ref.append_targets(_t(pt), _t(lens), 5, 4)
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


# -- K1/K2 optimizer steps ------------------------------------------------------


def _close(got, want, dtype, scale=None):
    """f32: within 2 ulp of the reference; bf16: within 1 bf16 ulp. With
    ``scale`` (the elementwise largest operand magnitude) the bound grows by
    that many ulps of the operands: the Pallas kernel in interpret mode
    contracts ``a*b + c`` into one rounding where ``ref.py`` rounds twice,
    which moves a result that cancels by up to an ulp of its operands (the
    reference suite allows it 3e-7 absolute, tests/test_packed_optim.py)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = (lambda a: 2 * np.spacing(np.abs(a))) if dtype == "float32" else _bf16_ulp
    lim = ulp(want) + (0 if scale is None else ulp(scale))
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


def _scale(against, *arrays, like=None):
    """Elementwise largest operand magnitude (for interpret mode), reduced
    over the worker axis for a per-column output ``like``."""
    if against == "ref":
        return None
    sc = functools.reduce(np.maximum, [np.abs(a) for a in arrays])
    return sc.max(axis=0) if like is not None and like.dim() == 1 else sc


def _jax_call(jx, against, fn_name, *args, **kw):
    """The reference op on the CPU: its ``ref.py`` body, or the Pallas kernel
    in interpret mode through its ``ops`` wrapper."""
    fam = fn_name.split(".")[0]
    if against == "ref":
        return getattr(getattr(jx, fam + "_ref"), fn_name.split(".")[1])(*args, **kw)
    with jx.flags.force_pallas():
        return getattr(getattr(jx, fam + "_ops"), fn_name.split(".")[2])(*args, **kw)


OPT_NS = [384, 300]  # 128-aligned, and ragged (the JAX wrapper pads)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
def test_sgd_step_plain_matches_jax(against, dtype, nesterov, weight_decay, rng, jx):
    kw = dict(momentum=0.9, nesterov=nesterov, weight_decay=weight_decay)
    tdt = getattr(torch, dtype)
    for n in OPT_NS:
        x, g, m = (rng.normal(size=(4, n)).astype(np.float32) for _ in range(3))
        jargs = [jx.jnp.asarray(a, dtype) for a in (x, g, m)] + [jx.jnp.asarray(0.05, jx.jnp.float32)]
        want = _jax_call(jx, against, "opt.sgd_update.sgd_step", *jargs, **kw)
        tx, tm = _t(x, tdt), _t(m, tdt)
        got = opt_ops.sgd_step(tx, _t(g, tdt), tm, torch.tensor(0.05), **kw)
        assert got[0] is tx and got[1] is tm  # in place
        for a, b in zip(got, want):
            _close(a.float().numpy(), np.asarray(b.astype(jx.jnp.float32)), dtype, _scale(against, x, g, m))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
def test_adamw_step_plain_matches_jax(against, dtype, weight_decay, rng, jx):
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=weight_decay)
    tdt = getattr(torch, dtype)
    c1, c2 = np.float32(1 - 0.9**3), np.float32(1 - 0.95**3)
    for n in OPT_NS:
        x, g = (rng.normal(size=(4, n)).astype(np.float32) for _ in range(2))
        mu = 0.1 * rng.normal(size=(4, n)).astype(np.float32)
        nu = rng.random(size=(4, n)).astype(np.float32)
        f32 = jx.jnp.float32
        jargs = [jx.jnp.asarray(x, dtype), jx.jnp.asarray(g, dtype), jx.jnp.asarray(mu), jx.jnp.asarray(nu),
                 jx.jnp.asarray(0.05, f32), jx.jnp.asarray(c1, f32), jx.jnp.asarray(c2, f32)]
        want = _jax_call(jx, against, "opt.adamw_update.adamw_step", *jargs, **kw)
        got = opt_ops.adamw_step(_t(x, tdt), _t(g, tdt), _t(mu), _t(nu), torch.tensor(0.05),
                                 torch.tensor(c1), torch.tensor(c2), **kw)
        sc = _scale(against, x, g, mu, nu)
        _close(got[0].float().numpy(), np.asarray(want[0].astype(f32)), dtype, sc)
        for a, b in zip(got[1:], want[1:]):
            _close(a.numpy(), np.asarray(b), "float32", sc)


def test_opt_steps_keep_padding_lanes_zero(rng):
    """Padding lanes (zero in x, g and the state) stay exactly zero."""
    x = torch.zeros(3, 256)
    x[:, :200] = _t(rng.normal(size=(3, 200)).astype(np.float32))
    g = torch.zeros_like(x)
    g[:, :200] = _t(rng.normal(size=(3, 200)).astype(np.float32))
    m, mu, nu = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    lr, c = torch.tensor(0.1), torch.tensor(0.5)
    for _ in range(3):
        opt_ops.sgd_step(x, g, m, lr, momentum=0.9, nesterov=True, weight_decay=1e-4)
    y = x.clone()
    for _ in range(3):
        opt_ops.adamw_step(y, g, mu, nu, lr, c, c, b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)
    for t in (x, m, y, mu, nu):
        assert torch.count_nonzero(t[:, 200:]) == 0
    assert torch.count_nonzero(x[:, :200]) > 0


def test_weak_constants_round_to_the_tensor_dtype():
    """JAX's weakly typed Python scalars take the array's dtype: 0.9 in bf16
    is 0.8984375. PyTorch would multiply by float32(0.9)."""
    assert opt_ref.weak(0.9, torch.bfloat16) == 0.8984375
    assert opt_ref.weak(0.9, torch.float32) == float(np.float32(0.9))


# -- K5 plain pullback ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8,), (13, 7), (3, 5, 9), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
def test_anchor_mix_plain_matches_jax(against, dtype, shape, rng, jx):
    """The cases of the reference's own sweep (tests/test_kernels.py), x
    updated in place."""
    tdt = getattr(torch, dtype)
    x = rng.normal(size=shape).astype(np.float32)
    z = rng.normal(size=shape).astype(np.float32)
    for alpha in (0.0, 0.5, 0.6, 1.0):
        want = _jax_call(jx, against, "am.anchor_mix.anchor_mix", jx.jnp.asarray(x, dtype), jx.jnp.asarray(z, dtype),
                         alpha)
        want = np.asarray(want.astype(jx.jnp.float32))
        tx = _t(x, tdt)
        got = am_ops.anchor_mix(tx, _t(z, tdt), alpha)
        assert got is tx and got.dtype == tdt and got.shape == shape
        got = got.float().numpy()
        if against == "ref":
            assert np.array_equal(got, want), alpha
        else:
            xz = np.maximum(np.abs(_t(x, tdt).float().numpy()), np.abs(_t(z, tdt).float().numpy()))
            ulp = np.spacing(xz) if dtype == "float32" else _bf16_ulp(xz)
            assert (np.abs(got - want) <= ulp).all(), alpha


def test_pullback_tree_maps_anchor_mix_over_a_tree(rng):
    x = {"a": _t(rng.normal(size=(4, 3)).astype(np.float32)), "b": {"c": _t(rng.normal(size=(7,)).astype(np.float32))}}
    z = {"a": torch.zeros(4, 3), "b": {"c": torch.ones(7)}}
    want = {"a": am_ref.anchor_mix(x["a"], z["a"], 0.6), "c": am_ref.anchor_mix(x["b"]["c"], z["b"]["c"], 0.6)}
    out = am_ops.pullback_tree(x, z, 0.6)
    assert out["a"] is x["a"] and torch.equal(out["a"], want["a"]) and torch.equal(out["b"]["c"], want["c"])


# -- K3/K4 fused boundaries --------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
def test_pullback_plain_matches_jax(against, dtype, m, rng, jx):
    """Masked (one dead row) and unmasked, K4 with and without mean_pre."""
    n, alpha, beta = 384, 0.6, 0.7
    tdt = getattr(torch, dtype)
    x = rng.normal(size=(m, n)).astype(np.float32)
    z = rng.normal(size=(n,)).astype(np.float32)
    v = 0.1 * rng.normal(size=(n,)).astype(np.float32)
    masks = [None]
    if m > 1:
        w = np.full(m, 1.0 / (m - 1), np.float32)
        w[m // 2] = 0.0
        masks.append(w)
    jx_ = lambda a: jx.jnp.asarray(a, dtype)  # noqa: E731
    for w in masks:
        jw = None if w is None else jx.jnp.asarray(w)
        tw = None if w is None else _t(w)
        want = _jax_call(jx, against, "am.pullback_mean_momentum.pullback_mean_momentum",
                         jx_(x), jx_(z), jx_(v), alpha, beta, weights=jw)
        tx, tz, tv = _t(x, tdt), _t(z, tdt), _t(v, tdt)
        got = am_ops.pullback_mean_momentum(tx, tz, tv, alpha, beta, weights=tw)
        assert got[0] is tx and got[2] is tv and torch.equal(tz, _t(z, tdt))  # x, v in place; z kept
        for a, b in zip(got, want):
            sc = _scale(against, x, z[None], v[None], like=a)
            _close(a.float().numpy(), np.asarray(b.astype(jx.jnp.float32)), dtype, sc)
        for mean_pre in (False, True):
            want = _jax_call(jx, against, "am.pullback_mean.pullback_mean", jx_(x), jx_(z), alpha,
                             mean_pre=mean_pre, weights=jw)
            got = am_ops.pullback_mean(_t(x, tdt), _t(z, tdt), alpha, mean_pre=mean_pre, weights=tw)
            for a, b in zip(got, want):
                sc = _scale(against, x, z[None], like=a)
                _close(a.float().numpy(), np.asarray(b.astype(jx.jnp.float32)), dtype, sc)


def test_worker_mean_sums_rows_in_order(rng):
    """The plain worker mean is the f32 row sum in order 0..m-1 over m — the
    order the CUDA kernel uses, so the card can hold them bit for bit."""
    x = _t(rng.normal(size=(7, 64)).astype(np.float32) * np.float32(1e3))
    acc = x[0].clone()
    for i in range(1, 7):
        acc = acc + x[i]
    assert torch.equal(am_ref.worker_mean(x), acc / torch.tensor(7.0))
    w = _t(rng.random(7).astype(np.float32))
    acc = x[0] * w[0]
    for i in range(1, 7):
        acc = acc + x[i] * w[i]
    assert torch.equal(am_ref.worker_mean(x, w), acc)


def test_pullback_probe_raises_until_k8():
    """K8 is ported: ``probe=True`` no longer raises; K3/K4 return the
    probe of the pre-pullback plane as their last output."""
    x, z = torch.arange(256.0).reshape(2, 128), torch.zeros(128)
    want = probe_ref.plane_probe(x)
    out = am_ops.pullback_mean(x.clone(), z, 0.5, probe=True)
    assert len(out) == 3 and torch.equal(out[2], want)
    out = am_ops.pullback_mean_momentum(x.clone(), z, z.clone(), 0.5, 0.7, probe=True)
    assert len(out) == 4 and torch.equal(out[3], want)


# -- dispatch -----------------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_without_building(rng):
    """A CPU tensor goes to the plain version: no launch is counted and no
    library is built (there is no nvcc here)."""
    before = {k.name: k.launches for k in all_kernels()}
    x = _t(rng.normal(size=(3, 32)).astype(np.float32))
    s = _t(np.ones(32, np.float32))
    torch.testing.assert_close(rms_ops.rmsnorm_2d(x, s), rms_ref.rmsnorm(x, s), rtol=0, atol=0)
    q, pk, pv, pt, lens = _attend_case(rng)
    pa_ops.paged_attend_gqa(*map(_t, (q, pk, pv, pt, lens)))
    pa_ops.paged_append_(_t(pk), _t(pk[:3, :1]), _t(pt), _t(lens))
    buf, lr = torch.zeros(2, 128), torch.tensor(0.1)
    opt_ops.sgd_step(buf, buf.clone(), buf.clone(), lr, momentum=0.9, nesterov=True, weight_decay=0.0)
    opt_ops.adamw_step(buf, buf.clone(), buf.clone(), buf.clone(), lr, lr, lr, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.0)
    am_ops.anchor_mix(buf, buf.clone(), 0.6)
    am_ops.pullback_mean(buf, buf[0].clone(), 0.6)
    am_ops.pullback_mean_momentum(buf, buf[0].clone(), buf[0].clone(), 0.6, 0.7)
    am_ops.pullback_mean(buf, buf[0].clone(), 0.6, probe=True)
    am_ops.pullback_mean_momentum(buf, buf[0].clone(), buf[0].clone(), 0.6, 0.7, probe=True)
    probe_ops.probe_buffer(buf)
    fq = _t(rng.normal(size=(1, 4, 2, 64)).astype(np.float32)).requires_grad_(True)
    fa_ops.flash_attention(fq, fq[:, :, :1], fq[:, :, :1]).sum().backward()
    fa_ops.dkdv_sum(torch.zeros(2, 3, 1, 4, 1, 64), torch.bfloat16)
    rms_ops.rmsnorm(x.requires_grad_(True), s).sum().backward()
    wr = _t(rng.normal(size=(1, 5, 2, 4)).astype(np.float32)).requires_grad_(True)
    y, st = wkv_ops.wkv(wr, wr, wr, torch.sigmoid(wr), wr[0, 0], chunk=4)
    (y.sum() + st.sum()).backward()
    sx = _t(rng.normal(size=(1, 10, 2, 4)).astype(np.float32)).requires_grad_(True)
    sb = _t(rng.normal(size=(1, 10, 1, 3)).astype(np.float32)).requires_grad_(True)
    y, st = ssd_ops.ssd_scan(sx, torch.sigmoid(sx[..., 0]), -torch.ones(2), sb, sb, torch.ones(2), chunk=4)
    (y.sum() + st.sum()).backward()
    assert {k.name: k.launches for k in all_kernels()} == before
    assert all(k._lib is None for k in all_kernels())


def test_wrappers_reject_bad_inputs(rng):
    with pytest.raises(ValueError, match="rows, d"):
        rms_ops.rmsnorm_2d(torch.zeros(2, 3, 4), torch.ones(4))
    with pytest.raises(ValueError, match="pool"):
        pa_ops.paged_append_(torch.zeros(4, 4, 2), torch.zeros(1, 1, 2), torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        q, pk, pv, pt, lens = _attend_case(rng)
        pa_ops.paged_attend_gqa(*map(_t, (q, pk, pv, pt, lens)), window=0)
    buf, lr = torch.zeros(2, 128), torch.tensor(0.1)
    with pytest.raises(ValueError, match="shape"):
        opt_ops.sgd_step(buf, torch.zeros(2, 64), buf.clone(), lr, momentum=0.9, nesterov=True, weight_decay=0.0)
    with pytest.raises(ValueError, match="float32"):
        opt_ops.sgd_step(buf, buf.clone(), buf.clone(), 0.1 * torch.ones(2), momentum=0.9, nesterov=True,
                         weight_decay=0.0)
    with pytest.raises(TypeError, match="float32"):
        opt_ops.adamw_step(buf, buf.clone(), buf.bfloat16(), buf.clone(), lr, lr, lr, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=0.0)
    with pytest.raises(ValueError, match="anchor"):
        am_ops.pullback_mean(buf, torch.zeros(64), 0.6)
    with pytest.raises(ValueError, match="z must match"):
        am_ops.anchor_mix(buf, buf.bfloat16(), 0.6)
    with pytest.raises(ValueError, match="weights"):
        am_ops.pullback_mean(buf, torch.zeros(128), 0.6, weights=torch.ones(3))
    with pytest.raises(ValueError, match=r"\(m, n\)"):
        probe_ops.probe_buffer(torch.zeros(3, 4, 5))
    q, kv = torch.zeros(1, 4, 3, 64), torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="GQA"):
        fa_ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention(q[:, :, :2], kv, kv, True, 0)
    with pytest.raises(TypeError, match="dtypes"):
        fa_ops.flash_attention(q[:, :, :2], kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="sk_valid"):
        fa_ops.flash_attention_fwd(q[:, :, :2], kv, kv, sk_valid=5)
    with pytest.raises(ValueError, match="rows, d"):
        rms_ops.rmsnorm_bwd(torch.zeros(2, 4), torch.ones(4), torch.zeros(3, 4))


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_vs_plain_on_card(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for rows in (1, 4, 32):
        x = torch.randn(rows, 3584, generator=gen, device=cuda).to(dtype)
        s = (1 + 0.1 * torch.randn(3584, generator=gen, device=cuda)).to(dtype)
        got, want = rms_ops.rmsnorm_2d(x, s, eps=1e-6).float(), rms_ref.rmsnorm(x, s, 1e-6).float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        else:
            assert ((got - want).abs() <= torch.from_numpy(_bf16_ulp(want.cpu().numpy())).to(cuda)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 32])
def test_paged_append_kernel_bitwise_on_card(cuda, t):
    gen = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.randn(129, 16, 4, 128, generator=gen, device=cuda).to(torch.bfloat16)
    new = torch.randn(4, t, 4, 128, generator=gen, device=cuda).to(torch.bfloat16)
    pt = (torch.randperm(128, generator=gen, device=cuda).to(torch.int32) + 1).reshape(4, 32).contiguous()
    pt[0] = 0
    lens = torch.tensor([0, 17, 300, 511 if t == 1 else 500], dtype=torch.int32, device=cuda)
    got = pa_ops.paged_append_(pool.clone(), new, pt, lens)
    want = pa_ref.paged_append_(pool.clone(), new, pt, lens)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 32, 700])
def test_paged_append_kv_kernel_bitwise_on_card(cuda, t):
    """Both pools in one launch, bitwise the plain version on each pool: at
    decode, at a prefill chunk, and at S*T = 2,800 rows (350 CTAs, the later
    writers' targets in three tiles), with two idle slots on page 0 and
    positions clamped past the table's end."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    pools = [torch.randn(129, 16, 4, 128, generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2)]
    news = [torch.randn(4, t, 4, 128, generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2)]
    pt = (torch.randperm(128, generator=gen, device=cuda).to(torch.int32) + 1).reshape(4, 32).contiguous()
    pt[0] = 0
    pt[2] = 0
    lens = torch.tensor([0, 17, 0, {1: 511, 32: 500, 700: 300}[t]], dtype=torch.int32, device=cuda)
    got = pa_ops.paged_append_kv_(pools[0].clone(), pools[1].clone(), news[0], news[1], pt, lens)
    for g, pool, new in zip(got, pools, news):
        assert torch.equal(g, pa_ref.paged_append_(pool.clone(), new, pt, lens))


@pytest.mark.cuda
def test_paged_append_and_rmsnorm_wrappers_raise_on_card(cuda):
    """Each check of the CUDA paths raises its error class: a dtype the
    kernel does not take, a tensor on another device, a non-contiguous pool
    or row block, a table of the wrong shape."""
    pool = torch.zeros(9, 8, 2, 16, device=cuda)
    new = torch.zeros(2, 1, 2, 16, device=cuda)
    pt = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        pa_ops.paged_append_kv_(pool, pool.clone(), new, new, pt.long(), lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa_ops.paged_append_(pool.half(), new, pt, lens)
    with pytest.raises(ValueError, match="devices"):
        pa_ops.paged_append_kv_(pool, pool.clone(), new, new, pt.cpu(), lens)
    strided = torch.zeros(9, 8, 16, 2, device=cuda).transpose(2, 3)  # the pool's shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_append_(strided, new, pt, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_append_kv_(pool, strided, new, new, pt, lens)
    with pytest.raises(ValueError, match="page_tables"):
        pa_ops.paged_append_kv_(pool, pool.clone(), new, new, pt[:1], lens)
    x, s = torch.zeros(4, 64, device=cuda), torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="scale on cpu"):
        rms_ops.rmsnorm_2d(x, s.cpu())
    with pytest.raises(TypeError, match="dtype"):
        rms_ops.rmsnorm_2d(x, s.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rms_ops.rmsnorm_2d(x.half(), s.half())
    with pytest.raises(ValueError, match="contiguous"):
        rms_ops.rmsnorm_2d(torch.zeros(64, 4, device=cuda).t(), s)
    with pytest.raises(ValueError, match="dy on cpu"):
        rms_ops.rmsnorm_bwd(x, s, x.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d", RMS_PLAN_DS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernels_at_every_plan_on_card(cuda, dtype, d):
    """K7 forward and backward at each branch of the planner (a sub-warp a
    row at 64 and 80, a CTA a row at 2048, 3584 and 4096, the block kernel
    at 4097), at ragged row counts, within the stated bounds, and the same
    bits on a second launch."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    for rows in (1, 7, 33, 300, 4099):
        x = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=cuda)).to(dtype)
        dy = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
        y, want = rms_ops.rmsnorm_2d(x, s), rms_ref.rmsnorm(x, s)
        assert torch.equal(y, rms_ops.rmsnorm_2d(x, s))
        err = (y.float() - want.float()).abs()
        if dtype == torch.float32:
            assert bool((err <= 2e-5 * want.abs() + 1e-6).all())
        else:
            assert bool((err <= torch.from_numpy(_bf16_ulp(want.float().cpu().numpy())).to(cuda)).all())
        got = rms_ops.rmsnorm_bwd(x, s, dy)
        assert all(torch.equal(a, b) for a, b in zip(got, rms_ops.rmsnorm_bwd(x, s, dy)))
        for a, w in zip(got, rms_ref.rmsnorm_bwd(x, s, dy)):
            e, w = (a.float() - w.float()).abs(), w.float()
            lim = 1e-5 * w.abs().max()
            if dtype == torch.bfloat16:
                lim = lim + torch.from_numpy(_bf16_ulp(w.cpu().numpy())).to(cuda)
            assert bool((e <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
def test_paged_attend_kernel_vs_plain_on_card(cuda, window):
    gen = torch.Generator(device=cuda).manual_seed(0)
    pk = torch.randn(129, 16, 4, 128, generator=gen, device=cuda)
    pv = torch.randn(129, 16, 4, 128, generator=gen, device=cuda)
    pt = (torch.randperm(128, generator=gen, device=cuda).to(torch.int32) + 1).reshape(4, 32).contiguous()
    pt[0] = 0
    lens = torch.tensor([0, 17, 300, 511], dtype=torch.int32, device=cuda)
    q = torch.randn(4, 4, 7, 128, generator=gen, device=cuda) / 128**0.5
    got = pa_ops.paged_attend_decode(q, pk, pv, pt, lens, window=window)
    want = pa_ref.paged_attend_gqa(q.reshape(4, 1, 28, 128), pk, pv, pt, lens, window=window).reshape(q.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)



def _card_case(cuda, dtype, m=16, n=17408):
    gen = torch.Generator(device=cuda).manual_seed(0)
    return [torch.randn(m, n, generator=gen, device=cuda).to(dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opt_step_kernels_bitwise_on_card(cuda, dtype):
    x, g, m = _card_case(cuda, dtype)
    lr = torch.full((), 0.05, device=cuda)
    kw = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
    want = opt_ref.sgd_update(x, g, m, lr, **kw)
    got = opt_ops.sgd_step(x.clone(), g, m.clone(), lr, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mu, nu = x.float().abs() * 0.1, g.float().abs()
    c = torch.full((), 0.3, device=cuda)
    akw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)
    want = opt_ref.adamw_update(x, g, mu, nu, lr, c, c, **akw)
    got = opt_ops.adamw_step(x.clone(), g, mu.clone(), nu.clone(), lr, c, c, **akw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_anchor_mix_kernels_bitwise_on_card(cuda, dtype, masked):
    x, zz, vv = _card_case(cuda, dtype)
    z, v = zz[0].contiguous(), vv[0].contiguous()
    w = None
    if masked:
        w = torch.full((16,), 1 / 15, device=cuda)
        w[3] = 0.0
    want = am_ref.pullback_mean_momentum(x, z, v, 0.6, 0.7, weights=w)
    got = am_ops.pullback_mean_momentum(x.clone(), z, v.clone(), 0.6, 0.7, weights=w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for mean_pre in (False, True):
        want = am_ref.pullback_mean(x, z, 0.6, mean_pre=mean_pre, weights=w)
        got = am_ops.pullback_mean(x.clone(), z, 0.6, mean_pre=mean_pre, weights=w)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_consensus_probe_kernels_on_card(cuda, dtype):
    """K8 within rtol 1e-6 of the plain version at the classifier's plane and
    at a ragged width (the scalar path), the same bits on a second launch;
    the probe output of K3 and K4 (masked or not, mean_pre) bit for bit
    K8's on a copy of the pre-boundary plane, and their other outputs bit
    for bit those without the probe."""
    x, zz, vv = _card_case(cuda, dtype)
    z, v = zz[0].contiguous(), vv[0].contiguous()
    for xs in (x, x[:, :1003].contiguous()):
        got = probe_ops.probe_buffer(xs)
        torch.testing.assert_close(got, probe_ref.plane_probe(xs), rtol=1e-6, atol=0)
        assert torch.equal(probe_ops.probe_buffer(xs), got)
    want = probe_ops.probe_buffer(x)
    w = torch.full((16,), 1 / 15, device=cuda)
    w[3] = 0.0
    for weights in (None, w):
        got = am_ops.pullback_mean_momentum(x.clone(), z, v.clone(), 0.6, 0.7, probe=True, weights=weights)
        plain = am_ops.pullback_mean_momentum(x.clone(), z, v.clone(), 0.6, 0.7, weights=weights)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], plain)) and torch.equal(got[3], want)
        for mean_pre in (False, True):
            got = am_ops.pullback_mean(x.clone(), z, 0.6, mean_pre=mean_pre, probe=True, weights=weights)
            plain = am_ops.pullback_mean(x.clone(), z, 0.6, mean_pre=mean_pre, weights=weights)
            assert all(torch.equal(a, b) for a, b in zip(got[:2], plain)) and torch.equal(got[2], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_anchor_mix_kernel_bitwise_on_card(cuda, dtype):
    """K5 at the classifier's gossip plane, a ragged length (the scalar
    tail) and views one element off 16-byte alignment (the scalar path)."""
    x, z, _ = _card_case(cuda, dtype)
    n = 100003  # of the 278,528 elements
    flat_x, flat_z = x.reshape(-1).clone(), z.reshape(-1)
    for xs, zs in ((x.clone(), z), (flat_x[:n].clone(), flat_z[:n]), (flat_x[1:], flat_z[1:])):
        want = am_ref.anchor_mix(xs, zs, 0.6)
        assert am_ops.anchor_mix(xs, zs, 0.6) is xs and torch.equal(xs, want)


# (B, Sq, Sk, H, Hkv, D, causal, window, q_offset, sk_valid): the LM slice's
# shape, h2o-danube-1.8b's head_dim 80, zamba2-1.2b's shared block, a ragged
# S with a padded K (NaN past sk_valid), a window, a q_offset
FA_CARD = [
    (2, 512, 512, 28, 4, 128, True, None, 0, None),
    (2, 512, 512, 32, 8, 80, True, None, 0, None),
    (2, 512, 512, 32, 32, 64, True, 4096, 0, None),
    (1, 130, 160, 4, 2, 64, False, None, 0, 130),
    (2, 256, 256, 8, 2, 128, True, 64, 0, None),
    (2, 64, 320, 8, 4, 64, True, None, 256, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CARD, ids=["slice", "head_dim_80", "zamba2", "ragged", "window", "q_offset"])
def test_flash_attention_kernels_vs_plain_on_card(cuda, case, dtype):
    """Bounds as chip_smoke.py states them (max|Δ| / max|plain|): f32 1e-5
    forward, 2e-5 gradients; bf16 2^-7 both. Keys past sk_valid hold NaN,
    which must not leak; a second launch of the forward and of the backward
    gives the same bits."""
    b, sq, sk, h, hkv, d, causal, window, q_offset, sk_valid = case
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = (torch.randn(b, sq, h, d, generator=gen, device=cuda) / d**0.5).to(dtype)
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    dout = torch.randn(b, sq, h, d, generator=gen, device=cuda).to(dtype)
    if sk_valid is not None:
        k[:, sk_valid:], v[:, sk_valid:] = float("nan"), float("nan")
    out, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    out_p, _ = fa_ref.flash_attention_fwd(q, k, v, **kw)
    f32 = dtype == torch.float32

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    assert rel(out, out_p) <= (1e-5 if f32 else 2.0**-7)
    assert all(torch.equal(a, w) for a, w in zip((out, lse), fa_ops.flash_attention_fwd(q, k, v, **kw)))
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = fa_ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all()) and rel(a, w) <= (2e-5 if f32 else 2.0**-7)
    again = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, w) for a, w in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_dkdv_sum_kernel_on_card(cuda):
    """The split sum at the qwen2 slice's partials (7 splits of B 2, S 512,
    4 KV heads, D 128): the same bits as its plain version, which adds in
    the same order and rounds once."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    part = torch.randn(2, 7, 2, 512, 4, 128, generator=gen, device=cuda)
    before = fa_ops.BWD_DKDV_SUM.launches
    got = fa_ops.dkdv_sum(part, torch.bfloat16)
    assert fa_ops.BWD_DKDV_SUM.launches == before + 1
    assert all(torch.equal(a, w) for a, w in zip(got, fa_ref.dkdv_sum(part, torch.bfloat16)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_vs_plain_on_card(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for rows in (7, 1024):
        x = torch.randn(rows, 3584, generator=gen, device=cuda).to(dtype)
        s = (1 + 0.1 * torch.randn(3584, generator=gen, device=cuda)).to(dtype)
        dy = torch.randn(rows, 3584, generator=gen, device=cuda).to(dtype)
        got = rms_ops.rmsnorm_bwd(x, s, dy, eps=1e-6)
        want = rms_ref.rmsnorm_bwd(x, s, dy, 1e-6)
        for a, w in zip(got, want):
            err, w = (a.float() - w.float()).abs(), w.float()
            lim = 1e-5 * w.abs().max()
            if dtype == torch.bfloat16:
                lim = lim + torch.from_numpy(_bf16_ulp(w.cpu().numpy())).to(cuda)
            assert bool((err <= lim).all())
        assert all(torch.equal(a, b) for a, b in zip(got, rms_ops.rmsnorm_bwd(x, s, dy, eps=1e-6)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_kernel_group_12_on_card(cuda, dtype):
    """mistral-large's GQA group (96 heads over 8 KV heads: G = 12), which
    takes the kernel's group-capacity-16 instance; bounds as chip_smoke.py
    states them: f32 1e-5 absolute, bf16 2^-8·|plain| + 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    pk, pv = (torch.randn(129, 16, 8, 128, generator=gen, device=cuda).to(dtype) for _ in range(2))
    pt = (torch.randperm(128, generator=gen, device=cuda).to(torch.int32) + 1).reshape(4, 32).contiguous()
    pt[0] = 0
    lens = torch.tensor([0, 17, 300, 511], dtype=torch.int32, device=cuda)
    q = (torch.randn(4, 8, 12, 128, generator=gen, device=cuda) / 128**0.5).to(dtype)
    for window in (None, 64):
        got = pa_ops.paged_attend_decode(q, pk, pv, pt, lens, window=window)
        want = pa_ref.paged_attend_gqa(q.reshape(4, 1, 96, 128), pk, pv, pt, lens, window=window).reshape(4, 8, 12, 128)
        lim = 2.0**-8 * want.abs() + 1e-5 if dtype == torch.bfloat16 else torch.full_like(want, 1e-5)
        assert bool(((got.float() - want).abs() <= lim).all())


# (B, S, H, N = P, chunk, r/k/v/u dtype): the reduced rwkv6-7b's shape with a
# ragged last chunk, and the rwkv6 slice's; w is f32 in both
WKV_CARD = [(2, 45, 4, 32, 16, torch.float32), (2, 512, 64, 64, 32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CARD, ids=["reduced", "slice"])
def test_wkv_kernels_vs_plain_on_card(cuda, case):
    """K12 forward and the backward kernel against the plain ``wkv_chunked``
    and torch autograd through it, with cotangents for y and the final
    state; bounds as chip_smoke.py states them (max|Δ| / max|plain|): f32
    2e-5 for y and the state, 1e-4 for each gradient; bf16 2^-7 for y, 2e-5
    for the f32 state, 2^-5 for each gradient. The same bits on a second
    launch."""
    b, s, h, n, chunk, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    r, k, v = (torch.randn(b, s, h, n, generator=gen, device=cuda).to(dtype) for _ in range(3))
    w = 0.2 + 0.79 * torch.rand(b, s, h, n, generator=gen, device=cuda)
    u = torch.randn(h, n, generator=gen, device=cuda).to(dtype)
    dy = torch.randn(b, s, h, n, generator=gen, device=cuda).to(dtype)
    dstate = torch.randn(b, h, n, n, generator=gen, device=cuda)
    y, st, states = wkv_ops.wkv_bh(r, k, v, w, u, chunk=chunk, save_states=True)
    grads = wkv_ops.wkv_bwd_bh(r, k, v, w, u, dy, states, dstate, chunk=chunk)
    ins = [t.detach().clone().requires_grad_(True) for t in (r, k, v, w, u)]
    yp, stp = wkv_ref.wkv_chunked(*ins, chunk=chunk)
    plain = torch.autograd.grad((yp, stp), ins, (dy, dstate))
    f32 = dtype == torch.float32

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    assert rel(y, yp) <= (2e-5 if f32 else 2.0**-7) and rel(st, stp) <= 2e-5
    for g, pg in zip(grads, plain):
        assert g.dtype == pg.dtype and rel(g, pg) <= (1e-4 if f32 else 2.0**-5)
    again = wkv_ops.wkv_bwd_bh(r, k, v, w, u, dy, states, dstate, chunk=chunk)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert torch.equal(wkv_ops.wkv_bh(r, k, v, w, u, chunk=chunk)[0], y)
    # the autograd Function: the same kernels, counted once each
    before = (wkv_ops.FWD.launches, wkv_ops.BWD.launches)
    ya, sa = wkv_ops.wkv(*ins, chunk=chunk)
    got = torch.autograd.grad((ya, sa), ins, (dy, dstate))
    assert (wkv_ops.FWD.launches, wkv_ops.BWD.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(ya, y) and all(torch.equal(a, c) for a, c in zip(got, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_kernel_head_dim_80_on_card(cuda, dtype):
    """h2o-danube-1.8b's decode attention (32 heads over 8 KV heads, G 4,
    head_dim 80: lanes own three columns, the last lanes fewer, and the Q.K
    loop ends on a 16-column tail); bounds as chip_smoke.py states them: f32
    1e-5 absolute, bf16 2^-8·|plain| + 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    pk, pv = (torch.randn(129, 16, 8, 80, generator=gen, device=cuda).to(dtype) for _ in range(2))
    pt = (torch.randperm(128, generator=gen, device=cuda).to(torch.int32) + 1).reshape(4, 32).contiguous()
    pt[0] = 0
    lens = torch.tensor([0, 17, 300, 511], dtype=torch.int32, device=cuda)
    q = (torch.randn(4, 8, 4, 80, generator=gen, device=cuda) / 80**0.5).to(dtype)
    for window in (None, 64):
        got = pa_ops.paged_attend_decode(q, pk, pv, pt, lens, window=window)
        want = pa_ref.paged_attend_gqa(q.reshape(4, 1, 32, 80), pk, pv, pt, lens, window=window).reshape(4, 8, 4, 80)
        lim = 2.0**-8 * want.abs() + 1e-5 if dtype == torch.bfloat16 else torch.full_like(want, 1e-5)
        assert bool(((got.float() - want).abs() <= lim).all())


# (B, S, H, P, G, N, chunk, x/B/C dtype): the reduced zamba2's SSM shape with a
# ragged last chunk, and the zamba2 slice's; dt and A are f32 in both
SSD_CARD = [(2, 45, 16, 32, 1, 16, 16, torch.float32), (2, 512, 64, 64, 1, 64, 128, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CARD, ids=["reduced", "slice"])
def test_ssd_kernels_vs_plain_on_card(cuda, case):
    """K11 forward and the backward kernel against the plain ``ssd_chunked``
    (y before the D-skip: D = 0, x/B/C read in f32) and torch autograd
    through it, with cotangents for y and the final state; bounds as
    chip_smoke.py states them (max|Δ| / max|plain|): f32 2e-5 for y and the
    state, 1e-4 for each gradient; bf16 inputs the same for the f32 y and
    state, 2^-7 for dx, dB and dC (rounded once to bf16) and 1e-4 for the
    f32 ddt and dA. The same bits on a second launch; the autograd Function
    counts one launch of each."""
    b, s, h, p, g, n, chunk, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, s, h, p, generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device=cuda))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda))
    B, C = (torch.randn(b, s, g, n, generator=gen, device=cuda).to(dtype) for _ in range(2))
    dy = torch.randn(b, s, h, p, generator=gen, device=cuda)
    dstate = torch.randn(b, h, p, n, generator=gen, device=cuda)
    y, st, states = ssd_ops.ssd_scan_bh(x, dt, A, B, C, chunk=chunk, save_states=True)
    grads = ssd_ops.ssd_scan_bwd_bh(x, dt, A, B, C, dy, states, dstate, chunk=chunk)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    yp, stp = ssd_ref.ssd_chunked(ins[0].float(), ins[1], ins[2], ins[3].float(), ins[4].float(),
                                  torch.zeros(h, device=cuda), chunk=chunk)
    plain = torch.autograd.grad((yp, stp), ins, (dy, dstate))
    f32 = dtype == torch.float32

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    assert rel(y, yp) <= 2e-5 and rel(st, stp) <= 2e-5
    for name, gk, pg in zip(("x", "dt", "A", "B", "C"), grads, plain):
        bound = 1e-4 if f32 or name in ("dt", "A") else 2.0**-7
        assert gk.dtype == pg.dtype and rel(gk, pg) <= bound, (name, rel(gk, pg))
    again = ssd_ops.ssd_scan_bwd_bh(x, dt, A, B, C, dy, states, dstate, chunk=chunk)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert torch.equal(ssd_ops.ssd_scan_bh(x, dt, A, B, C, chunk=chunk)[0], y)
    before = (ssd_ops.FWD.launches, ssd_ops.BWD.launches)
    D = torch.zeros(h, device=cuda)
    ya, sa = ssd_ops.ssd_scan(*ins, D, chunk=chunk)
    got = torch.autograd.grad((ya, sa), ins, (dy.to(dtype), dstate))
    assert (ssd_ops.FWD.launches, ssd_ops.BWD.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(ya, y.to(dtype)) and torch.equal(sa, st)
    assert all(rel(a, c) <= 2.0**-7 for a, c in zip(got, grads))
