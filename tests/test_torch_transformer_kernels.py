"""The port's K15 ``flash_attention`` and K16 ``rmsnorm`` (their plain
versions, which the wrappers run on CPU tensors) held against the JAX
reference.

Inputs are made from a seed with numpy and handed to both packages.  The
JAX ops run their Pallas kernels in interpret mode, as
``tests/test_kernels_transformer.py`` runs them, at that file's shapes plus
head dim 128 and GQA 6:1 (Qwen2-1.5B's 12 query heads on 2 KV heads), with
its tolerances: rmsnorm 1e-5 in float32, 2e-2 in bfloat16; attention
2e-3.  Unlike that file, q and k are not scaled down: the scores have a
standard deviation of about 1, so each query attends to a few keys and a
wrong mask or a coarse rounding of the probabilities shows.  The Pallas attention is compared only where its key
length is at most 128 or a multiple of 128: above 128 and ragged, its last
key block reads past the keys and the result is NaN (pinned below), so at
ragged lengths the port is held against the JAX plain
``ref.flash_attention``.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import attention, common, mamba2, rmsnorm, rwkv6
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import registry as tregistry

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's gates, held here)

ATTN_TOL = 2e-3
JNP = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {np.float32: torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arr(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def both(a, dtype=np.float32):
    """The same values in both packages, rounded once to ``dtype``."""
    j = jnp.asarray(a).astype(JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH[dtype])


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("rows,d", [(1, 128), (300, 256), (8, 512),
                                    (33, 1536)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rmsnorm_matches_the_pallas_op(rows, d, dtype):
    jx, tx = both(arr(rows * d, rows, d), dtype)
    jw, tw = both(arr(d, d), dtype)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    got = tops.rmsnorm(tx, tw)
    assert got.dtype == TORCH[dtype] and got.shape == (rows, d)
    np.testing.assert_allclose(f32(got), f32(jops.rmsnorm(jx, jw)),
                               rtol=tol, atol=tol)


def test_rmsnorm_flattens_leading_dims_and_rounds_like_the_reference():
    """(B, T, D) through the op equals the row wrapper on (B·T, D); in
    bfloat16 ``x·r`` is rounded before the product with ``w``, bit for bit
    the reference's plain version."""
    jx, tx = both(arr(7, 2, 5, 64), "bfloat16")
    jw, tw = both(arr(8, 64), "bfloat16")
    got = tops.rmsnorm(tx, tw, 1e-5)
    flat = rmsnorm.rmsnorm(tx.reshape(10, 64), tw, 1e-5).reshape(2, 5, 64)
    assert torch.equal(got, flat)
    np.testing.assert_array_equal(f32(got), f32(jref.rmsnorm(jx, jw, 1e-5)))


@pytest.mark.parametrize("b,hq,hkv,t,d", [
    (1, 4, 4, 128, 64),
    (2, 8, 2, 256, 64),       # GQA
    (1, 2, 1, 384, 128),      # MQA
    (1, 2, 2, 128, 128),      # head dim 128
    (1, 12, 2, 128, 128),     # GQA 6:1, Qwen2-1.5B's heads
    (2, 4, 1, 64, 32),        # the smoke model's heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_the_pallas_op(b, hq, hkv, t, d, causal):
    jq, tq = both(arr(1, b, hq, t, d))
    jk, tk = both(arr(2, b, hkv, t, d))
    jv, tv = both(arr(3, b, hkv, t, d))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(f32(got), f32(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_flash_attention_q_offset_matches_the_pallas_op():
    """Chunked decode: 64 queries at the end of a 256-key cache."""
    jq, tq = both(arr(4, 2, 4, 64, 64))
    jk, tk = both(arr(5, 2, 4, 256, 64))
    jv, tv = both(arr(6, 2, 4, 256, 64))
    got = tops.flash_attention(tq, tk, tv, causal=True, q_offset=192)
    want = jops.flash_attention(jq, jk, jv, causal=True, q_offset=192)
    np.testing.assert_allclose(f32(got), f32(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("tq,tk,q_offset,causal", [
    (200, 200, 0, True), (200, 200, 0, False), (64, 300, 236, True),
    (1, 77, 76, True), (5, 9, 4, True)])
def test_flash_attention_at_ragged_lengths_matches_the_plain_reference(
        tq, tk, q_offset, causal):
    """Ragged key lengths (and the decode shape, one query) against the
    JAX plain version, GQA 6:1 at head dim 128."""
    jq, tq_ = both(arr(7, 1, 12, tq, 128))
    jk, tk_ = both(arr(8, 1, 2, tk, 128))
    jv, tv_ = both(arr(9, 1, 2, tk, 128))
    got = tops.flash_attention(tq_, tk_, tv_, causal=causal,
                               q_offset=q_offset)
    want = jref.flash_attention(jq, jnp.repeat(jk, 6, axis=1),
                                jnp.repeat(jv, 6, axis=1), causal=causal,
                                q_offset=q_offset)
    np.testing.assert_allclose(f32(got), f32(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def attention_with_p_in_bf16(q, k, v, causal, q_offset):
    """The plain attention as a tensor-core attention rounds it (as
    FlashAttention and SDPA do): scores and softmax in float32, p = exp(s
    - max) in [0, 1] rounded to bfloat16 before P·V, the normaliser summed
    from the float32 p; the output left in float32.  q, k, v: (BH, T, D)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * q.shape[-1] ** -0.5
    if causal:
        qi = torch.arange(q.shape[1])[:, None] + q_offset
        s = s.masked_fill(torch.arange(k.shape[1])[None, :] > qi, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).float(), vf)
    return pv / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("bh,tq,tk,d,causal,q_offset", [
    (3, 1, 77, 128, True, 76), (3, 5, 9, 32, True, 4),
    (3, 200, 200, 64, False, 0), (3, 64, 300, 128, True, 236),
    (3, 1000, 1000, 112, True, 0), (3, 100, 612, 128, True, 512),
    (1, 2048, 2048, 128, True, 0), (1, 1024, 1024, 112, True, 0)])
def test_rounding_p_to_bf16_stays_inside_the_bf16_tolerance(
        bh, tq, tk, d, causal, q_offset):
    """The argument for rounding P to bfloat16 in a tensor-core K15
    (PERF.md), on the card tests' kind of input (bfloat16 q, k, v, unit
    normal and unscaled, so attention is
    peaked): rounding p in [0, 1] once to bfloat16 moves each weight by at
    most 2^-9 relative, so the output moves by at most 2^-9 · max |v|
    (plus float32 summation error); after the output's own rounding to
    bfloat16 it stays within the card's bf16 tolerance (2e-2) of the plain
    version, which keeps p in float32."""
    rng = np.random.default_rng(tq * 7 + tk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (bh, t, d)).astype(np.float32)).to(torch.bfloat16)
        for t in (tq, tk, tk))
    got = attention_with_p_in_bf16(q, k, v, causal, q_offset)
    want = tref.flash_attention(q[:, None].float(), k[:, None].float(),
                                v[:, None].float(), causal=causal,
                                q_offset=q_offset)[:, 0]
    bound = 2.0 ** -9 * float(v.float().abs().max())
    moved = float((got - want).abs().max())
    assert 0 < moved <= bound + 1e-5, (moved, bound)
    plain = tref.flash_attention(q[:, None], k[:, None], v[:, None],
                                 causal=causal, q_offset=q_offset)[:, 0]
    torch.testing.assert_close(got.to(torch.bfloat16).float(), plain.float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("tq,d,seed", [(256, 128, 0), (200, 112, 1),
                                       (128, 64, 2)])
def test_the_bf16_score_control_fails_the_layer_gate_where_p_in_bf16_passes(
        tq, d, seed):
    """chip_smoke 9b's per-layer gate holds K15 within its bf16 tolerance
    (2e-2 normwise) of the plain attention on Qwen2-1.5B's layer inputs,
    whose scaled scores span about ±300 at the reference's init.  On such
    inputs the gate's control, the plain attention with the scaled scores
    rounded to bfloat16, must fail the gate, while a tensor-core kernel's
    rounding (p rounded to bfloat16 before P·V) stays inside it."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, tq, d)).astype(np.float32) * g).to(torch.bfloat16)
        for g in (8.0, 8.0, 1.0))
    span = float((q.float() @ k.float().transpose(1, 2)).abs().max()) * \
        d ** -0.5
    assert 200 < span < 600, span
    tol = chip_smoke.TF_TOL["bfloat16"][1]
    plain = chip_smoke.plain_attention(tref, q, k, v, causal=True)
    control = chip_smoke.attention_bf16_scores(tref, q, k, v, causal=True)
    p_bf16 = attention_with_p_in_bf16(q, k, v, True, 0).to(torch.bfloat16)
    assert chip_smoke.normwise(control, plain) > tol
    assert chip_smoke.normwise(p_bf16, plain) <= tol
    # the control is the plain attention but for the scores' rounding
    assert torch.equal(
        chip_smoke.attention_bf16_scores(tref, q[:, :1], k[:, :1],
                                         v[:, :1], causal=True),
        plain[:, :1])


def test_the_layer_capture_returns_each_layers_attention_inputs():
    """chip_smoke 9b's per-layer gate catches each layer's (q, k, v) where
    ``ops.flash_attention`` hands them to ``attention.flash_attention``
    (heads flattened, GQA repeated, after RoPE): on the smoke Qwen2, one
    call a layer at the wrapper's shapes, and the prefill on the caught
    calls' plain attention equals the plain path's."""
    model = tregistry.build_smoke("qwen2-1.5b", device="cpu")
    cfg = model.cfg
    params = model.init(0)
    B, T = 2, 40
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, T)).astype(np.int32))
    want, _ = model.prefill(params, tok, 48)
    with chip_smoke.capture_attention(attention, tref) as calls:
        got, _ = model.prefill(params, tok, 48)
    assert attention.flash_attention is not calls  # restored on exit
    assert len(calls) == cfg.n_layers
    for q, k, v, kw in calls:
        for t in (q, k, v):
            assert t.shape == (B * cfg.n_heads, T, cfg.head_dim)
            assert t.dtype == torch.bfloat16 and t.is_contiguous()
        assert kw["causal"] and kw.get("q_offset", 0) == 0
    # GQA repeated: each KV head's keys stand for n_heads / n_kv_heads
    # query heads
    k0 = calls[0][1].view(B, cfg.n_heads, T, cfg.head_dim)
    rep = cfg.n_heads // cfg.n_kv_heads
    assert torch.equal(k0[:, 0], k0[:, rep - 1])
    assert torch.equal(got, want)


def test_reference_pallas_attention_is_nan_past_128_ragged_keys():
    """The reference caveat: at T = 200 the JAX Pallas op's second key
    block (keys 128..255) reads 56 rows past the keys; rows 128..199 come
    out NaN in interpret mode.  The port masks those keys: finite, and
    equal to the plain reference within the attention tolerance."""
    jq, tq = both(arr(10, 1, 2, 200, 32))
    jk, tk = both(arr(11, 1, 2, 200, 32))
    jv, tv = both(arr(12, 1, 2, 200, 32))
    pallas = f32(jops.flash_attention(jq, jk, jv, causal=True))
    nan_rows = np.isnan(pallas).any(axis=(0, 1, 3))
    assert not nan_rows[:128].any() and nan_rows[128:].all()
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert bool(torch.isfinite(got).all())
    want = f32(jref.flash_attention(jq, jk, jv, causal=True))
    np.testing.assert_allclose(f32(got), want, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(f32(got)[:, :, :128], pallas[:, :, :128],
                               rtol=ATTN_TOL, atol=ATTN_TOL)


def test_wrappers_on_the_cpu_are_the_plain_versions_and_count_nothing():
    common.TRANSFORMER_LIB.reset_launches()
    q = torch.from_numpy(arr(13, 6, 40, 32))
    k = torch.from_numpy(arr(14, 6, 50, 32))
    v = torch.from_numpy(arr(15, 6, 50, 32))
    got = attention.flash_attention(q, k, v, causal=True, q_offset=10)
    want = tref.flash_attention(q[:, None], k[:, None], v[:, None],
                                causal=True, q_offset=10)[:, 0]
    assert torch.equal(got, want)
    x, w = torch.from_numpy(arr(16, 9, 48)), torch.from_numpy(arr(17, 48))
    assert torch.equal(rmsnorm.rmsnorm(x, w, 1e-5), tref.rmsnorm(x, w, 1e-5))
    r, u = torch.from_numpy(arr(18, 3, 20, 16)), torch.from_numpy(arr(19, 3, 16))
    want = tref.rwkv6_scan(*[r.transpose(0, 1)[None]] * 4, u)[0].transpose(0, 1)
    assert torch.equal(rwkv6.wkv6(r, r, r, r, u), want)
    xs, a = torch.from_numpy(arr(20, 1, 20, 2, 4)), -torch.from_numpy(
        np.abs(arr(21, 1, 20, 2)))
    assert torch.equal(mamba2.ssd(xs, a, r[:1], r[:1]),
                       tref.mamba2_ssd(xs, a, r[:1], r[:1]))
    assert common.TRANSFORMER_LIB.launches == {"rmsnorm": 0,
                                               "flash_attention": 0,
                                               "wkv6": 0, "ssd": 0}


@pytest.mark.parametrize("op", ["rmsnorm", "flash_attention"])
def test_the_ops_refuse_float16(op):
    """The kernels take float32 and bfloat16 only; the ops say so on every
    device rather than run float16 through the plain version."""
    x = torch.zeros(1, 2, 8, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        if op == "rmsnorm":
            tops.rmsnorm(x, torch.zeros(32, dtype=torch.float16))
        else:
            tops.flash_attention(x, x, x, causal=True)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        rmsnorm.rmsnorm(x, torch.zeros(16, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        rmsnorm.rmsnorm(x.int(), torch.zeros(16).int())
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rmsnorm(torch.zeros(16, 4).T, torch.zeros(16))
    q = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="q_offset"):
        attention.flash_attention(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="shape"):
        attention.flash_attention(q, torch.zeros(2, 8, 16), q)
    with pytest.raises(ValueError, match="at least one key"):
        attention.flash_attention(q, q[:, :0], q[:, :0])


# ---------------------------------------------------------------------------
# K17 wkv6 in chunks: the plain mirror, and the kernel's source under
# emulation (csrc/transformer.cu's K17 span built with g++)
# ---------------------------------------------------------------------------
WKV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def wkv_inputs(seed, b, t, h, kd, vd):
    """r, k, v (0.5 N) and u (0.3 N) as the JAX tests draw them; w as
    rwkv6's time mixing makes it, ``exp(-exp(x))`` with x ~ N(0, 2) (so
    that some underflow to 0 and, in bf16, some round to 1), with channel
    0 of every head exactly 0 and channel 1 exactly 1, and, given two
    heads or more, the last head exactly 1 throughout.  float32 numpy,
    (B, T, H, ·) and u (H, K)."""
    rng = np.random.default_rng(seed)

    def f(*s, sc=0.5):
        return (rng.standard_normal(s) * sc).astype(np.float32)
    r, k, v = f(b, t, h, kd), f(b, t, h, kd), f(b, t, h, vd)
    w = np.exp(-np.exp(2.0 * rng.standard_normal((b, t, h, kd)))).astype(
        np.float32)
    w[..., 0], w[..., 1] = 0.0, 1.0
    if h > 1:
        w[:, :, -1] = 1.0
    return r, k, v, w, f(h, kd, sc=0.3)


def wkv_close(got, want, dtype):
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= WKV_TOL[dtype], err
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=WKV_TOL[dtype], atol=WKV_TOL[dtype])


@pytest.mark.parametrize("kd,vd", [(16, 24), (64, 64), (100, 200)])
@pytest.mark.parametrize("t", [1, rwkv6.KERNEL_CHUNK - 1,
                               rwkv6.KERNEL_CHUNK + 1, 1000])
def test_plain_chunked_wkv6_matches_the_reference(t, kd, vd):
    """``ref.rwkv6_scan_chunked`` (the K17 kernel's three steps in plain
    torch) against the port's step-by-step ``ref.rwkv6_scan`` and JAX's
    Pallas ``wkv6`` (through its op, interpret mode), float32 within 1e-5
    normwise, at the decays the model draws (exact 0 and 1 included)."""
    arrays = wkv_inputs(t * 7 + kd, 1, t, 2, kd, vd)
    tin = [torch.from_numpy(a) for a in arrays]
    got = tref.rwkv6_scan_chunked(*tin, chunk=rwkv6.KERNEL_CHUNK)
    wkv_close(got, tref.rwkv6_scan(*tin), torch.float32)
    want = np.array(jops.rwkv6_scan(*[jnp.asarray(a) for a in arrays]))
    wkv_close(got, torch.from_numpy(want), torch.float32)


@pytest.fixture(scope="module")
def emulated_wkv6(tmp_path_factory):
    """K17's span of ``csrc/transformer.cu`` (its three kernels, launcher
    and dispatch) built for the CPU, with the helpers it takes from the
    file's top and a C entry that runs it as ``tf_wkv6`` does."""
    import ctypes

    import emu_build
    code = r"""
inline float to_f(float v) { return v; }
inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> T from_f(float v);
template <> inline float from_f<float>(float v) { return v; }
template <> inline __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
""" + emu_build.span(common.TRANSFORMER_LIB.source.read_text(), "K17")
    code = code.replace("extern __shared__ __align__(16) unsigned char "
                        "wkv_raw[];", "unsigned char* wkv_raw = emu_smem();")
    code += r"""
extern "C" int emu_wkv6(int BH, int Tn, int K, int V, int dtype, void* r,
                        void* k, void* v, void* w, void* u, void* o,
                        void* scratch) {
  if (dtype == 0)
    return wkv6_for_dim<float>(BH, Tn, K, V, r, k, v, w, u, o, scratch,
                               nullptr);
  return wkv6_for_dim<__nv_bfloat16>(BH, Tn, K, V, r, k, v, w, u, o,
                                     scratch, nullptr);
}
"""
    P, I = ctypes.c_void_p, ctypes.c_int
    return emu_build.build(tmp_path_factory.mktemp("wkv6_emu"), code,
                           {"emu_wkv6": [I] * 5 + [P] * 7})


@pytest.mark.parametrize("bh,t,kd,vd,dtype", [
    (2, 1, 16, 24, torch.float32),
    (2, rwkv6.KERNEL_CHUNK - 1, 64, 64, torch.bfloat16),
    (2, rwkv6.KERNEL_CHUNK + 1, 100, 200, torch.float32),
    (3, 2 * rwkv6.KERNEL_CHUNK + 1, 100, 30, torch.bfloat16),
    (1, 1000, 64, 64, torch.float32),
    (2, 200, 16, 24, torch.bfloat16)],
    ids=["t1", "c-1-bf16", "c+1", "2c+1-unaligned-bf16", "t1000",
         "t200-bf16"])
def test_wkv6_kernel_source_matches_plain_under_emulation(emulated_wkv6, bh,
                                                          t, kd, vd, dtype):
    """The three K17 kernels as the C entry launches them, in the wrapper's
    scratch, against the step-by-step plain scan (float32 1e-5 normwise,
    bf16 2e-2), at the decays the model draws; bf16 rows of 100 (200
    bytes) and 30 (60) are not whole 16-byte vectors and take the plain
    loads."""
    r, k, v, w, u = (torch.from_numpy(a[0] if a.ndim == 4 else a).to(dtype)
                     for a in wkv_inputs(bh * t + kd, 1, t, bh, kd, vd))
    # the wrapper's layout: rows (BH, T, ·), u per row
    r, k, v, w = (x.transpose(0, 1).contiguous() for x in (r, k, v, w))
    out = torch.empty(bh, t, vd, dtype=dtype)
    scratch = torch.empty(rwkv6.scratch_floats(bh, t, kd, vd))
    assert emulated_wkv6.emu_wkv6(
        bh, t, kd, vd, common.DTYPE_CODES[dtype],
        *(x.data_ptr() for x in (r, k, v, w, u, out, scratch))) == 0
    want = rwkv6.wkv6(r, k, v, w, u)            # the CPU route: plain scan
    wkv_close(out, want, dtype)
