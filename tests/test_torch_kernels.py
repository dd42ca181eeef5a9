"""Port kernels (repro_torch) against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that plain version against the JAX ``ref.py`` body and against the Pallas
kernel in interpret mode, on the same seeded numpy inputs. Tests marked
``cuda`` hold the hand-written CUDA kernels against the plain versions on
the card and skip where there is none.

Stated tolerances: RMSNorm f32 rtol 1e-6/atol 1e-6 (same formula, sums in
another order); bf16 one bf16 ulp (the f32 results may straddle a rounding
boundary). Paged append: bitwise. Paged attend f32 2e-6 (the reference's
own kernel tolerance: online vs two-pass softmax).
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import all_kernels
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.kernels.paged_attn import ref as pa_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref


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
