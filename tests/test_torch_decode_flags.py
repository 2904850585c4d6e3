"""The port's decode flags, ``decode_gqa_packed`` and ``decode_kv_int8``,
held against the port's baseline and the JAX reference on the same
parameters.

Qwen2-1.5B's smoke config (2 layers, 4 query heads on 1 KV head, head dim
32) on the JAX model's ``PRNGKey(0)`` parameters, carried across with
``params_from_reference``; tokens from numpy with a seed.

- ``decode_gqa_packed`` contracts each KV head with its G query heads and
  never repeats the cache.  On the CPU its products are float32 products
  of the cast operands, one a query head, the shape the unpacked einsum
  hands the BLAS: the packed logits and cache equal the unpacked ones bit
  for bit (the reference's own test asks that of its packed path), and
  the packed path is within the normwise tolerances of
  ``test_torch_models.py`` (float32 1e-4, bfloat16 1e-1) of the
  reference's packed path.
- ``decode_kv_int8``: the int8 cache and its scales against the
  reference's int8 rollout on the same tokens, the logits within the same
  tolerances (measured: bit for bit but at the clamped write past the
  cache, 4.5e-3 in bfloat16), and so are the scales; the dequantized
  cache too, in float32 within two quantization levels (``QUANT_TOL``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.sched import serving as jserving
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.models import transformer as jT
from repro.runtime import flags as jflags

from repro_torch.core.sched import serving as tserving
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as tT
from repro_torch.runtime import flags as tflags

NORM_TOL = {"bfloat16": 1e-1, "float32": 1e-4}
#: the dequantized int8 cache against the reference's, normwise, in
#: float32: two quantization levels of the largest row (a value that the
#: two packages round to either side of a level's midpoint lands one level
#: apart; one such flip reads 6.1e-3).  In bfloat16 the wide cache's
#: tolerance holds (measured 2.4e-2: a row whose bf16 input differs by an
#: ulp has another scale, and its values move by up to 5 levels)
QUANT_TOL = 2 / 127
ARCH = "qwen2-1.5b"


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["bfloat16", "float32"])
def pair(request, monkeypatch):
    """(JAX model, JAX params, port model, port params, tolerance) of the
    smoke Qwen2-1.5B in the compute dtype of the parameter."""
    if request.param == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)
    jm = jregistry.build_smoke(ARCH)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tregistry.build_smoke(ARCH, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    return jm, jp, tm, tp, NORM_TOL[request.param]


def tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: normwise error {err:.3g} > {tol}"


def filled_cache(tm, tp, tok):
    """A cache after six per-lane steps of three lanes at depths 0, 2, 5."""
    c = tm.init_cache(3, 16)
    for t in range(6):
        pos = torch.tensor([t, t + 2, t + 5], dtype=torch.int32)
        tm.decode_step(tp, c, torch.from_numpy(tok[:, t:t + 1]), pos)
    return c


@pytest.mark.parametrize("where", ["scalar", "per_lane"])
def test_packed_decode_equals_the_baseline_bit_for_bit(pair, where):
    _jm, _jp, tm, tp, _tol = pair
    tok = tokens(0, 3, 8)
    cache = filled_cache(tm, tp, tok)
    pos = 7 if where == "scalar" else torch.tensor([3, 9, 12],
                                                   dtype=torch.int32)
    out = {}
    for packed in (False, True):
        c = {k: v.clone() for k, v in cache.items()}
        with tflags.use_flags(decode_gqa_packed=packed):
            out[packed] = tm.decode_step(tp, c, torch.from_numpy(tok[:, 6:7]),
                                         pos)
    (base, bc), (packed, pc) = out[False], out[True]
    assert torch.equal(packed, base)
    assert all(torch.equal(pc[k], bc[k]) for k in bc)


def test_packed_decode_matches_the_reference_packed_path(pair):
    """Scalar steps from position 0 (the last past the cache, a clamped
    write), then per-lane steps with a lane past the cache and one at a
    negative position, both packages under ``decode_gqa_packed``."""
    jm, jp, tm, tp, tol = pair
    tok = tokens(1, 3, 12)
    with tflags.use_flags(decode_gqa_packed=True), \
            jflags.use_flags(decode_gqa_packed=True):
        jc, tc = jm.init_cache(3, 10), tm.init_cache(3, 10)
        jstep = jax.jit(jm.decode_step)
        for t in list(range(6)) + [13]:
            col = tok[:, t % 12:t % 12 + 1]
            jl, jc = jstep(jp, jc, jnp.asarray(col), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(col), t)
            close(tl, jl, tol, f"scalar step {t}")
        for t, pos in enumerate(([6, 2, 9], [7, -3, 10], [8, 4, 11])):
            pos = np.asarray(pos, np.int32)
            col = tok[:, t:t + 1]
            jl, jc = jstep(jp, jc, jnp.asarray(col), jnp.asarray(pos))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(col),
                                    torch.from_numpy(pos))
            close(tl, jl, tol, f"per-lane step {t}")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"cache {k}")


def test_int8_cache_has_int8_leaves_scales_and_their_axes():
    """Under ``decode_kv_int8`` the cache is ``k``, ``v`` in int8 and
    float32 ``k_s``, ``v_s`` of (L, B, Hkv, max_len), ``cache_axes`` names
    the scales on the KV axes but the last, and the ``Server``'s slot
    reset zeroes a slot of all four; off the flag, the wide cache."""
    m = tregistry.build_smoke(ARCH, device="cpu")
    cfg = m.cfg
    with tflags.use_flags(decode_kv_int8=True):
        c = m.init_cache(2, 8)
        axes = m.cache_axes
        srv = tserving.Server(m, None, n_slots=2, max_len=8)
    assert set(c) == {"k", "v", "k_s", "v_s"}
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert c["k_s"].dtype == c["v_s"].dtype == torch.float32
    assert c["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 8, cfg.head_dim)
    assert c["k_s"].shape == c["k"].shape[:-1]
    assert axes["k_s"] == axes["v_s"] == axes["k"][:-1]
    assert set(srv.cache) == set(c)
    for t in srv.cache.values():
        t.fill_(1)
    with tflags.use_flags(decode_kv_int8=True):
        srv._reset_slot_cache(1)
    for name, t in srv.cache.items():
        assert not t[:, 1].any() and bool((t[:, 0] == 1).all()), name
    assert set(m.init_cache(2, 8)) == {"k", "v"}
    assert set(m.cache_axes) == {"k", "v"}


def test_int8_rollout_matches_the_reference(pair):
    """Token by token from position 0 under ``decode_kv_int8`` and
    ``decode_gqa_packed``, the last write past the cache (clamped):
    logits, the int8 values and the scales against the reference's."""
    jm, jp, tm, tp, tol = pair
    tok = tokens(4, 2, 12)
    with tflags.use_flags(decode_kv_int8=True, decode_gqa_packed=True), \
            jflags.use_flags(decode_kv_int8=True, decode_gqa_packed=True):
        qm = jregistry.build(jm.cfg)
        jc, tc = qm.init_cache(2, 12), tm.init_cache(2, 12)
        jstep = jax.jit(qm.decode_step)
        for t in list(range(11)) + [20]:
            col = tok[:, t % 12:t % 12 + 1]
            jl, jc = jstep(jp, jc, jnp.asarray(col), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(col), t)
            close(tl, jl, tol, f"step {t}")
    for k in ("k", "v"):
        assert tc[k].dtype == torch.int8
        close(tc[k].float() * tc[k + "_s"][..., None],
              np.asarray(jc[k], np.float32)
              * np.asarray(jc[k + "_s"])[..., None],
              max(tol, QUANT_TOL), f"dequantized cache {k}")
        close(tc[k + "_s"], jc[k + "_s"], tol, f"scales {k}_s")


def test_int8_rollout_stays_near_the_wide_cache_rollout(pair):
    """The reference's own check, on the port alone: the int8 rollout's
    logits within quantization tolerance of the wide cache's (rtol 0.15,
    atol 0.25), greedy argmax agreeing on more than 90 %."""
    _jm, _jp, tm, tp, _tol = pair
    tok = tokens(5, 2, 6)
    out = {}
    for int8 in (False, True):
        with tflags.use_flags(decode_kv_int8=int8, decode_gqa_packed=int8):
            c = tm.init_cache(2, 16)
            out[int8] = torch.stack([
                tm.decode_step(tp, c, torch.from_numpy(tok[:, t:t + 1]),
                               t)[0][:, 0] for t in range(6)]).float()
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(),
                               rtol=0.15, atol=0.25)
    assert float((out[True].argmax(-1) == out[False].argmax(-1))
                 .float().mean()) > 0.9


def test_int8_at_per_lane_positions_raises_in_both_packages(pair):
    jm, jp, tm, tp, _tol = pair
    col = tokens(6, 2, 1)
    pos = np.asarray([1, 2], np.int32)
    with tflags.use_flags(decode_kv_int8=True), \
            jflags.use_flags(decode_kv_int8=True):
        qm = jregistry.build(jm.cfg)
        with pytest.raises(ValueError, match="broadcasting"):
            qm.decode_step(jp, qm.init_cache(2, 8), jnp.asarray(col),
                           jnp.asarray(pos))
        with pytest.raises(ValueError, match="per-lane"):
            tm.decode_step(tp, tm.init_cache(2, 8), torch.from_numpy(col),
                           torch.from_numpy(pos))


def test_prefill_under_int8_keeps_a_wide_cache(pair):
    """As the reference's, ``prefill`` returns the wide cache under
    ``decode_kv_int8``: the flag changes ``init_cache`` alone."""
    jm, jp, tm, tp, tol = pair
    tok = tokens(7, 2, 8)
    with tflags.use_flags(decode_kv_int8=True), \
            jflags.use_flags(decode_kv_int8=True):
        tl, tc = tm.prefill(tp, torch.from_numpy(tok), 12)
        jl, jc = jT.prefill(jp, jm.cfg, jnp.asarray(tok), 12)
    assert set(tc) == set(jc) == {"k", "v"}
    assert tc["k"].dtype == tL.COMPUTE_DTYPE
    close(tl, jl, tol, "prefill logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"prefill cache {k}")


@pytest.mark.parametrize("policy", ["ooo", "naive"])
def test_server_under_packed_decode_matches_the_reference_server(
        monkeypatch, policy):
    """The port's ``Server`` under ``decode_gqa_packed`` (per-lane
    positions) returns the reference ``Server``'s tokens, steps and
    statistics in float32 (the last request runs into max_len)."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)
    jm = jregistry.build_smoke(ARCH)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tregistry.build_smoke(ARCH, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 512, int(rng.integers(2, 9))).tolist(),
             int(rng.integers(2, 12))) for _ in range(9)]
    reqs.append((list(range(7, 30)), 12))
    with tflags.use_flags(decode_gqa_packed=True), \
            jflags.use_flags(decode_gqa_packed=True):
        jsrv = jserving.Server(jm, jp, n_slots=4, max_len=28, policy=policy)
        tsrv = tserving.Server(tm, tp, n_slots=4, max_len=28, policy=policy)
        jreqs = [jserving.Request(i, list(p), m)
                 for i, (p, m) in enumerate(reqs)]
        treqs = [tserving.Request(i, list(p), m)
                 for i, (p, m) in enumerate(reqs)]
        for srv, rs in ((jsrv, jreqs), (tsrv, treqs)):
            for r in rs:
                srv.submit(r)
        jst, tst = jsrv.run(), tsrv.run()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.completed == len(reqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_block_decode_returns_the_scales_only_for_an_int8_cache(pair):
    """``block_decode`` (zamba2's shared block calls it too) returns (x,
    ck, cv) on a wide cache and (x, ck, cv, ks, vs) on an int8 one."""
    _jm, _jp, tm, tp, _tol = pair
    x = tT.embed_tokens(tp, torch.from_numpy(tokens(9, 2, 1)))
    lp = tp["layers"][0]
    wide = tm.init_cache(2, 8)
    assert len(tT.block_decode(lp, tm.cfg, x, wide["k"][0], wide["v"][0],
                               0)) == 3
    with tflags.use_flags(decode_kv_int8=True):
        q = tm.init_cache(2, 8)
    out = tT.block_decode(lp, tm.cfg, x, q["k"][0], q["v"][0], 0,
                          q["k_s"][0], q["v_s"][0])
    assert len(out) == 5 and bool(q["k_s"][0][:, :, 0].gt(0).all())
    assert not q["k_s"][0][:, :, 1:].any()
