"""The torch port's attention and RWKV6 ops vs the JAX package's kernels.

Inputs are drawn with numpy from a seed and fed to both packages. Here
the port's ops get CPU tensors, so they run their plain torch versions;
the JAX side runs the Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does) and the jnp references. Tolerances are
the JAX tests' own: attention 2e-6 in f32 and 2e-2 in bf16, RWKV6 1e-4,
all compared in f32. RWKV6 with bf16 inputs is held to 1e-4 too, not the
JAX file's 0.15: both sides widen the same bf16 values and run the
recurrence in f32, so only the order of the f32 sums differs. The CUDA
kernels are held against these plain versions on the card in
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as pallas_flash_attention
from repro.kernels import rwkv6_chunked as pallas_rwkv6_chunked
from repro.kernels.ref import mha_reference as jax_mha_reference
from repro.kernels.ref import rwkv6_reference as jax_rwkv6_reference
from repro_torch import kernels
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import ROUTES as ATTN_ROUTES
from repro_torch.kernels.flash_attention import \
    flash_attention as cuda_flash_attention
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked as cuda_rwkv6_chunked

# (B, H, KV, Sq, Skv, D): the grid of tests/test_kernels.py
ATTN_SHAPES = [(2, 4, 2, 128, 128, 64), (1, 4, 4, 256, 256, 32),
               (2, 4, 1, 128, 256, 64), (1, 8, 2, 64, 64, 128)]
# (B, H, T, D, chunk): the grid of tests/test_kernels.py
RWKV_SHAPES = [(2, 2, 64, 32, 16), (1, 4, 128, 64, 64), (2, 1, 256, 16, 128),
               (1, 2, 64, 64, 64)]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The per-tile emulations run long products on the CPU: under a
    parallel test run torch's intra-op threads compete with the other
    workers' and multiply the file's time many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _attn_inputs(b, h, kv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, kv, skv, d), dtype=np.float32),
            rng.standard_normal((b, kv, skv, d), dtype=np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(port, want, tol):
    np.testing.assert_allclose(_f32(port), _f32(want), atol=tol, rtol=tol)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,d", ATTN_SHAPES,
                         ids=_ids(ATTN_SHAPES))
def test_flash_attention_matches_jax(b, h, kv, sq, skv, d, dtype):
    arrays = _attn_inputs(b, h, kv, sq, skv, d, seed=sq + skv + d)
    out = ops.flash_attention(*_torch(arrays, dtype), causal=True,
                              block_q=64, block_kv=64)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (b, h, sq, d)
    jx = _jax(arrays, dtype)
    _close(out, jax_mha_reference(*jx, causal=True), TOL[dtype])
    if dtype == "float32" or (b, h) == (1, 8):   # the Pallas subset
        pk = pallas_flash_attention(*jx, causal=True, block_q=64,
                                    block_kv=64, interpret=True)
        _close(out, pk, TOL[dtype])


@pytest.mark.parametrize("window", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_and_noncausal(window, causal):
    """The window applies with and without the causal mask, as in the
    Pallas kernel."""
    arrays = _attn_inputs(1, 2, 2, 128, 128, 64, seed=window)
    out = ops.flash_attention(*_torch(arrays, "float32"), causal=causal,
                              window=window, block_q=64, block_kv=64)
    jx = _jax(arrays, "float32")
    _close(out, jax_mha_reference(*jx, causal=causal, window=window), 2e-6)
    _close(out, pallas_flash_attention(*jx, causal=causal, window=window,
                                       block_q=64, block_kv=64,
                                       interpret=True), 2e-6)


def test_flash_attention_fully_masked_rows_take_the_mean_of_v():
    """Causal with Sq > Skv: queries at negative positions see no key, so
    their scores are all -1e30 and their output is the uniform mean of v
    over all Skv keys (the reference and the Pallas kernel agree)."""
    b, h, kv, sq, skv, d = 1, 4, 2, 128, 64, 32
    arrays = _attn_inputs(b, h, kv, sq, skv, d, seed=5)
    out = ops.flash_attention(*_torch(arrays, "float32"), causal=True,
                              block_q=64, block_kv=64)
    mean_v = np.repeat(arrays[2].mean(axis=2, keepdims=True), h // kv, 1)
    np.testing.assert_allclose(out.numpy()[:, :, : sq - skv],
                               np.broadcast_to(mean_v, (b, h, sq - skv, d)),
                               atol=2e-6, rtol=2e-6)
    jx = _jax(arrays, "float32")
    _close(out, jax_mha_reference(*jx, causal=True), 2e-6)
    _close(out, pallas_flash_attention(*jx, causal=True, block_q=64,
                                       block_kv=64, interpret=True), 2e-6)


@pytest.mark.parametrize("window", [0, 96])
def test_flash_attention_end_aligned_prefill(window):
    """Sq < Skv: query i sits at position Skv - Sq + i (a prefill after a
    cache), with and without a window reaching back into the cache."""
    arrays = _attn_inputs(1, 4, 1, 64, 256, 64, seed=9 + window)
    out = ops.flash_attention(*_torch(arrays, "float32"), causal=True,
                              window=window, block_q=64, block_kv=64)
    jx = _jax(arrays, "float32")
    _close(out, jax_mha_reference(*jx, causal=True, window=window), 2e-6)
    _close(out, pallas_flash_attention(*jx, causal=True, window=window,
                                       block_q=64, block_kv=64,
                                       interpret=True), 2e-6)


# The bf16 kernel's precision contract: P split into two bf16 halves meets
# the card's bf16 limit against the f32 reference, P rounded to bf16 does
# not. (B, H, KV, S, D), bf16 causal.
SPLIT_P_SHAPES = [(1, 8, 2, 1024, 128), (1, 4, 1, 2048, 64)]
CARD_BF16_TOL = (1e-5, 1.6e-2)        # (atol, rtol) of the card's checks


def _over_card_limit(got, want):
    atol, rtol = CARD_BF16_TOL
    g, w = _f32(got), _f32(want)
    return int((np.abs(g - w) > atol + rtol * np.abs(w)).sum())


def _p_in_bf16(q, k, v):
    """Causal attention with P rounded to bf16 before the product with v
    (l from the f32 P): the fault the split into halves repairs."""
    sc = ref._scores(q, k, causal=True, window=0)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bksd->bkgqd", p.bfloat16().float(), v.float())
    return (o / p.sum(-1, keepdim=True)).reshape(q.shape).bfloat16()


@pytest.mark.parametrize("b,h,kv,s,d", SPLIT_P_SHAPES,
                         ids=_ids(SPLIT_P_SHAPES))
def test_split_p_meets_the_card_bf16_limit(b, h, kv, s, d):
    q, k, v = _torch(_attn_inputs(b, h, kv, s, s, d, seed=s + d), "bfloat16")
    want = ref.mha_reference(q, k, v, causal=True)
    split = ref.mha_split_p(q, k, v, causal=True)
    assert split.dtype == torch.bfloat16 and split.shape == q.shape
    assert _over_card_limit(split, want) == 0
    assert _over_card_limit(_p_in_bf16(q, k, v), want) > 0


# The f32 kernel's precision contract: every product in three TF32 passes
# (x = hi + lo, hi = tf32(x), lo = tf32(x - hi); hi.hi + (hi.lo + lo.hi))
# meets the JAX tests' 2e-6 against the f32 reference, one TF32 pass does
# not. (B, H, KV, S, D, window), f32 causal, GQA.
SPLIT_TF32_SHAPES = [(1, 8, 2, 1024, 128, 0), (1, 4, 1, 2048, 128, 0),
                     (1, 8, 2, 1024, 128, 256)]


def _over_f32_limit(got, want, tol=2e-6):
    g, w = _f32(got), _f32(want)
    return int((np.abs(g - w) > tol + tol * np.abs(w)).sum())


def _one_tf32_pass(q, k, v, *, causal, window):
    """Attention with both products in one TF32 pass (hi.hi only): the
    fault the three passes repair."""
    t = ref.tf32_rn
    s = torch.einsum("bkgqd,bksd->bkgqs", t(ref._grouped(q, k)), t(k))
    s = ref._mask(s / np.sqrt(q.shape[-1]), causal=causal, window=window)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bksd->bkgqd", t(p), t(v))
    return (o / p.sum(-1, keepdim=True)).reshape(q.shape)


@pytest.mark.parametrize("b,h,kv,s,d,window", SPLIT_TF32_SHAPES,
                         ids=_ids(SPLIT_TF32_SHAPES))
def test_split_tf32_meets_the_f32_limit(b, h, kv, s, d, window):
    arrays = _attn_inputs(b, h, kv, s, s, d, seed=s + d + window)
    q, k, v = _torch(arrays, "float32")
    split = ref.mha_split_tf32(q, k, v, causal=True, window=window)
    assert split.dtype == torch.float32 and split.shape == q.shape
    want = jax_mha_reference(*_jax(arrays, "float32"), causal=True,
                             window=window)
    _close(split, want, 2e-6)
    assert _over_f32_limit(_one_tf32_pass(q, k, v, causal=True,
                                          window=window), want) > 0


@pytest.mark.parametrize("window", [0, 96])
def test_split_tf32_matches_the_pallas_kernel(window):
    arrays = _attn_inputs(1, 4, 2, 256, 256, 128, seed=31 + window)
    split = ref.mha_split_tf32(*_torch(arrays, "float32"), causal=True,
                               window=window)
    _close(split, pallas_flash_attention(*_jax(arrays, "float32"),
                                         causal=True, window=window,
                                         block_q=64, block_kv=64,
                                         interpret=True), 2e-6)


def _trunc_f32(x):
    """f64 to f32, rounded toward zero."""
    r = x.to(torch.float32)
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _tensor_core_attention(q, k, v, *, window, per_tile, tile=64):
    """The f32 kernel's tiles (64 keys, causal, Sq = Skv a multiple of 64)
    with the tensor cores' accumulation modelled: each k8 instruction adds
    its 8 products, summed exactly, to the f32 accumulator and rounds the
    result toward zero. S starts from zero on each tile, the small passes
    first; P.V either starts from zero on each tile and joins O by one
    rounded multiply-add (``per_tile``, as the kernel does) or runs on in
    O's registers across the whole row."""
    qh, ql = (x.double() for x in ref._split_tf32(ref._grouped(q, k)))
    kh, kl = (x.double() for x in ref._split_tf32(k))
    vh, vl = (x.double() for x in ref._split_tf32(v))
    s_len, d = k.shape[2], k.shape[3]
    scale = 1.0 / torch.tensor(np.sqrt(d), dtype=torch.float32)
    m = torch.full(qh.shape[:-1] + (1,), ref.MASK_VALUE)
    l = torch.zeros_like(m)
    o = torch.zeros(qh.shape, dtype=torch.float32)

    def mma(acc, eq, pairs):
        for a, b in pairs:
            x = torch.einsum(eq, a, b)
            acc = _trunc_f32(x if acc is None else acc.double() + x)
        return acc

    for k0 in range(0, s_len, tile):
        keys = slice(k0, k0 + tile)
        cols = [slice(c, c + 8) for c in range(0, d, 8)]
        s = mma(None, "bkgqd,bksd->bkgqs",
                [p for c in cols for p in ((qh[..., c], kl[:, :, keys, c]),
                                           (ql[..., c], kh[:, :, keys, c]))]
                + [(qh[..., c], kh[:, :, keys, c]) for c in cols])
        full = torch.full(s.shape[:-1] + (s_len,), ref.MASK_VALUE)
        full[..., keys] = s * scale
        s = ref._mask(full, causal=True, window=window)[..., keys]
        n = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - n) * np.float32(np.log2(np.e)))
        p = torch.exp2((s - n) * np.float32(np.log2(np.e)))
        l, m = l * alpha + p.sum(-1, keepdim=True), n
        ph, pl = (x.double() for x in ref._split_tf32(p))
        js = [slice(j, j + 8) for j in range(0, tile, 8)]
        vk = [slice(k0 + j.start, k0 + j.stop) for j in js]
        pairs = ([x for j, c in zip(js, vk)
                  for x in ((pl[..., j], vh[:, :, c]),
                            (ph[..., j], vl[:, :, c]))]
                 + [(ph[..., j], vh[:, :, c]) for j, c in zip(js, vk)])
        if per_tile:
            pv = mma(None, "bkgqs,bksd->bkgqd", pairs)
            o = (o.double() * alpha.double() + pv.double()).to(torch.float32)
        else:
            o = mma(o * alpha, "bkgqs,bksd->bkgqd", pairs)
    return (o / l.clamp(min=1e-30)).reshape(q.shape)


# (B, H, KV, S, D): causal rows of 1,024 and 2,048 keys, GQA
TRUNCATION_SHAPES = [(1, 4, 2, 1024, 128), (1, 2, 1, 2048, 128)]


@pytest.mark.parametrize("b,h,kv,s,d", TRUNCATION_SHAPES,
                         ids=_ids(TRUNCATION_SHAPES))
def test_per_tile_pv_keeps_the_tensor_cores_truncation_in_the_f32_limit(
        b, h, kv, s, d):
    """Why the f32 kernel starts each tile's P.V from zero: the tensor
    cores round toward zero as they accumulate, and P.V accumulated across
    a whole row (3 x 1,024 / 8 = 384 truncating instructions at S 1,024)
    drifts over 2e-6, where 24 a tile and one rounded add into O stay
    inside it. ``ref.mha_split_tf32`` rounds to nearest and cannot tell
    the two apart."""
    arrays = _attn_inputs(b, h, kv, s, s, d, seed=s + d)
    q, k, v = _torch(arrays, "float32")
    want = jax_mha_reference(*_jax(arrays, "float32"), causal=True)
    tiled = _tensor_core_attention(q, k, v, window=0, per_tile=True)
    _close(tiled, want, 2e-6)
    whole = _tensor_core_attention(q, k, v, window=0, per_tile=False)
    assert _over_f32_limit(whole, want) > 0


def test_tf32_rn_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32 on the bit pattern: 10 mantissa bits kept, a tie
    rounds away from zero, infinities stay; hi + lo recovers 21 bits."""
    one = 2.0 ** -10                       # a TF32 step at 1.0
    x = torch.tensor([1.0, 1 + one / 2, 1 + 1.5 * one, -(1 + one / 2),
                      1 + one / 4, np.inf, -np.inf, 0.0], dtype=torch.float32)
    want = [1.0, 1 + one, 1 + 2 * one, -(1 + one), 1.0, np.inf, -np.inf, 0.0]
    assert ref.tf32_rn(x).tolist() == want
    bits = ref.tf32_rn(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0
    y = torch.from_numpy(np.random.default_rng(4).standard_normal(1000,
                                                                  np.float32))
    hi, lo = ref._split_tf32(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -21


# ---------------------------------------------------------------- RWKV6
def _rwkv_inputs(b, h, t, d, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    shp = (b, h, t, d)
    r, k, v = (rng.standard_normal(shp, dtype=np.float32) * scale
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal(shp, dtype=np.float32)))
         * 0.5 + 0.45).astype(np.float32)
    u = rng.standard_normal((h, d), dtype=np.float32) * scale
    return r, k, v, w, u


@pytest.mark.parametrize("b,h,t,d,chunk", RWKV_SHAPES, ids=_ids(RWKV_SHAPES))
def test_rwkv6_matches_jax(b, h, t, d, chunk):
    arrays = _rwkv_inputs(b, h, t, d, seed=t + d)
    y = ops.rwkv6_chunked(*_torch(arrays, "float32"), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (b, h, t, d)
    jx = _jax(arrays, "float32")
    want, _ = jax_rwkv6_reference(*jx)
    _close(y, want, 1e-4)
    _close(y, pallas_rwkv6_chunked(*jx, chunk=chunk, interpret=True), 1e-4)


def test_rwkv6_bf16_inputs():
    arrays = _rwkv_inputs(1, 2, 64, 32, seed=11, scale=1.0)
    y = ops.rwkv6_chunked(*_torch(arrays, "bfloat16"), chunk=32)
    assert y.dtype == torch.float32
    jx = _jax(arrays, "bfloat16")
    _close(y, jax_rwkv6_reference(*jx)[0], 1e-4)
    _close(y, pallas_rwkv6_chunked(*jx, chunk=32, interpret=True), 1e-4)


# The RWKV6 kernel's arithmetic: the u bonus factored out of the (D,D)
# work, y_j = r . S_{t-1}[:, j] + v_j q, q = sum_i r_i u_i k_i. It must meet
# the 1e-4 limit against the JAX reference and the Pallas kernel, and the
# limit must catch a bonus dropped (u = 0). (B, H, T, D, chunk)
FACTORED_SHAPES = [(2, 2, 64, 32, 16), (1, 2, 64, 64, 64)]


@pytest.mark.parametrize("dtype,scale", [("float32", 0.5), ("bfloat16", 1.0)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,chunk", FACTORED_SHAPES,
                         ids=_ids(FACTORED_SHAPES))
def test_rwkv6_factored_matches_jax(b, h, t, d, chunk, dtype, scale):
    arrays = _rwkv_inputs(b, h, t, d, seed=t + d + 1, scale=scale)
    y = ref.rwkv6_factored(*_torch(arrays, dtype))
    assert y.dtype == torch.float32 and y.shape == (b, h, t, d)
    jx = _jax(arrays, dtype)
    _close(y, jax_rwkv6_reference(*jx)[0], 1e-4)
    _close(y, pallas_rwkv6_chunked(*jx, chunk=chunk, interpret=True), 1e-4)


def test_rwkv6_limit_catches_a_dropped_bonus():
    r, k, v, w, u = _torch(_rwkv_inputs(1, 2, 64, 32, seed=21), "float32")
    want = _f32(ref.rwkv6_reference(r, k, v, w, u)[0])

    def over(y):
        return int((np.abs(_f32(y) - want) > 1e-4 + 1e-4 * np.abs(want)).sum())

    assert over(ref.rwkv6_factored(r, k, v, w, u)) == 0
    assert over(ref.rwkv6_factored(r, k, v, w, torch.zeros_like(u))) > 0


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_reference_final_state_matches_jax(with_state):
    arrays = _rwkv_inputs(2, 2, 48, 16, seed=13)
    state = (np.random.default_rng(3).standard_normal((2, 2, 16, 16),
                                                      dtype=np.float32)
             if with_state else None)
    y, final = ref.rwkv6_reference(
        *_torch(arrays, "float32"),
        state=None if state is None else torch.from_numpy(state))
    jy, jfinal = jax_rwkv6_reference(
        *_jax(arrays, "float32"),
        state=None if state is None else jnp.asarray(state))
    _close(y, jy, 1e-4)
    _close(final, jfinal, 1e-4)


# ------------------------------------------------------------ contracts
def _attn_tensors(b=1, h=4, kv=2, sq=64, skv=64, d=16):
    return _torch(_attn_inputs(b, h, kv, sq, skv, d, seed=0), "float32")


@pytest.mark.parametrize("sq,skv,bq,bkv", [(96, 64, 64, 64), (64, 96, 64, 64),
                                           (64, 64, 48, 64)])
def test_flash_attention_divisibility_raises(sq, skv, bq, bkv):
    q, k, v = _attn_tensors(sq=sq, skv=skv)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q, k, v, block_q=bq, block_kv=bkv)


def test_flash_attention_heads_must_group():
    q, k, v = _attn_tensors(h=6, kv=4)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, k, v)


def test_rwkv6_chunk_divisibility_raises():
    arrays = _torch(_rwkv_inputs(1, 2, 96, 16, seed=0), "float32")
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.rwkv6_chunked(*arrays, chunk=64)
    with pytest.raises(ValueError, match="u has shape"):
        ops.rwkv6_chunked(*arrays[:4], arrays[4][:1], chunk=32)


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrappers never compute on a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attention(*_attn_tensors())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rwkv6_chunked(*_torch(_rwkv_inputs(1, 2, 64, 16, seed=0),
                                   "float32"), chunk=32)


def test_ops_refuse_devices_without_kernel():
    q = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)
    x = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rwkv6_chunked(x, x, x, x, torch.zeros((2, 16), device="meta"),
                          chunk=8)


def test_attention_routes_by_dtype_to_built_sources():
    """bf16 goes to the wgmma kernel with P in bf16 halves, f32 to the
    wgmma kernel in three TF32 passes; each route names a source that the
    build compiles."""
    assert ATTN_ROUTES == {torch.bfloat16: "flash_attention_sm90",
                           torch.float32: "flash_attention_f32_sm90"}
    assert "flash_attention" not in build.KERNELS     # the FMA kernel is gone
    assert set(ATTN_ROUTES.values()) <= set(build.KERNELS)
    for counter in ("launches", "launches_sm90", "launches_f32"):
        assert isinstance(getattr(cuda_flash_attention, counter), int)


def test_kernels_package_exports_the_ops():
    assert kernels.flash_attention is ops.flash_attention
    assert kernels.rwkv6_chunked is ops.rwkv6_chunked
    assert ref.mha_reference is ops.mha_reference
    assert ref.rwkv6_reference is ops.rwkv6_reference


# ---------------------------------------------------------------- build
@pytest.mark.parametrize("name", build.KERNELS)
def test_build_target_covers_source_headers_and_flags(name, monkeypatch,
                                                      tmp_path):
    """An edit to the source, to any shared header or to the flags names
    another library, so a stale build is never loaded."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = {build._target(name).name}
    (tmp_path / "common.cuh").write_text(
        (tmp_path / "common.cuh").read_text() + "\n// edited\n")
    names.add(build._target(name).name)
    (tmp_path / f"{name}.cu").write_text(
        (tmp_path / f"{name}.cu").read_text() + "\n// edited\n")
    names.add(build._target(name).name)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    names.add(build._target(name).name)
    assert len(names) == 4
    assert all(n.startswith(f"lib{name}-") for n in names)


@pytest.mark.parametrize("name", ["flash_attention_f32_sm90",
                                  "flash_attention_sm90", "rwkv6_scan"])
def test_failed_build_of_new_kernels_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match=f"nvcc failed .* {name}.cu"):
        build.build(name)
    assert not list(tmp_path.glob("*.so"))
