"""The port's whisper-base (the audio family) held against the JAX
reference on the same parameters and inputs.

whisper-base's smoke config (2 encoder and 2 decoder layers, d_model 128,
4 heads of 32, d_ff 256, vocab 512) on the JAX model's ``PRNGKey(0)``
parameters, carried across with ``params_from_reference``, with the norm
weights and the MLP biases drawn non-zero and every weight matrix but the
embedding drawn at 1/sqrt(its input width), as ``test_torch_ssm.py`` and
phi3's checks in ``test_torch_models.py`` draw them (the reference's draw
takes a stacked leaf's fan-in from its layer count: its float32 logits
then part by 8.4e-5, near the limit, through the activations' size
alone).  Frames and tokens come from numpy with a seed; the encoder sees
64 frames, so the JAX side runs its Pallas attention in interpret mode
(exact at key lengths up to 128) on every call: the encoder's, the
decoder's causal one and the cross attention (16 queries on 64 keys).

Tolerance, normwise (the largest difference over the largest magnitude
of the reference's array), as ``test_torch_models.py``'s: float32 1e-4
(measured up to 2e-6 at this draw), bfloat16 1e-1 (measured up to
1.6e-2).  ``layers.gelu`` copies XLA's op-by-op expansion of
``jax.nn.gelu``'s tanh form and equals it bit for bit on every bfloat16
value but those whose float32 result is subnormal (XLA's CPU backend
flushes those to zero).  The ``Server`` and the launcher are compared in float32
on greedy tokens, steps and statistics, as ``test_torch_serving.py``
compares them.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.sched import serving as jserving
from repro.launch import serve as jlaunch
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.models import whisper as jW
from repro.runtime import flags as jflags

from repro_torch.configs import registry as tconfigs
from repro_torch.core.sched import serving as tserving
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry
from repro_torch.models import whisper as tW
from repro_torch.runtime import flags as tflags

NORM_TOL = {"bfloat16": 1e-1, "float32": 1e-4}
ARCH = "whisper-base"
B, TE, TD = 2, 64, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_params(jm, seed=11):
    """The JAX model's ``PRNGKey(0)`` parameters with the norm weights
    (1 + 0.2·N) and MLP biases (0.5·N) drawn from numpy, and every weight
    matrix but the embedding at 1/sqrt(its input width)."""
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "embed":
            return a
        if name in ("ln1", "ln2", "ln_x", "enc_norm", "final_norm"):
            return jnp.asarray(1 + 0.2 * rng.standard_normal(a.shape),
                               jnp.float32)
        if name in ("b_up", "b_down"):
            return jnp.asarray(0.5 * rng.standard_normal(a.shape),
                               jnp.float32)
        return jnp.asarray(rng.standard_normal(a.shape)
                           / np.sqrt(a.shape[-2]), jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, jp)


def make_pair(dtype, monkeypatch, width_draw=True):
    if dtype == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)
    jm = jregistry.build_smoke(ARCH)
    jp = reference_params(jm) if width_draw else jm.init(
        jax.random.PRNGKey(0))
    tm = tregistry.build_smoke(ARCH, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    return jm, jp, tm, tp, NORM_TOL[dtype]


@pytest.fixture(params=["bfloat16", "float32"])
def pair(request, monkeypatch):
    """The smoke whisper-base pair in the compute dtype of the parameter."""
    return make_pair(request.param, monkeypatch)


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: normwise error {err:.3g} > {tol}"


def inputs(seed, d_model):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, TE, d_model)).astype(np.float32)
    tok = rng.integers(0, 512, (B, TD)).astype(np.int32)
    return frames, tok


def test_template_and_config_are_the_references():
    """whisper-base's config is a copy, its template has the reference's
    tree, shapes, logical axes and initializers, and 97,197,056
    parameters; the smoke parameters split into per-layer views."""
    jm = jregistry.build_arch(ARCH)
    tcfg = tconfigs.get_config(ARCH)
    assert repr(tcfg) == repr(jm.cfg)
    jt = jax.tree_util.tree_flatten_with_path(
        jW.template(jm.cfg), is_leaf=lambda x: isinstance(x, jL.Spec))[0]
    tt = []

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            tt.append((path, node))
    walk((), tW.template(tcfg))
    assert sorted((tuple(k.key for k in p), (s.shape, s.axes, s.init,
                                             s.scale)) for p, s in jt) == \
        sorted((p, (s.shape, s.axes, s.init, s.scale)) for p, s in tt)
    m = tregistry.build(tcfg, device="cpu")
    assert m.param_count() == jm.param_count() == 97_197_056
    sm = tregistry.build_smoke(ARCH, device="cpu")
    p = sm.init(0)
    assert len(p["enc_layers"]) == len(p["dec_layers"]) == 2
    assert p["embed"].dtype == torch.bfloat16


def test_encode_matches(pair):
    jm, jp, tm, tp, tol = pair
    frames, _ = inputs(0, tm.cfg.d_model)
    je = jW.encode(jp, jm.cfg, jnp.asarray(frames))
    te = tW.encode(tp, tm.cfg, torch.from_numpy(frames))
    assert te.dtype == tL.COMPUTE_DTYPE
    close(te, je, tol, "encoder states")
    close(tW._sinusoid(TE, tm.cfg.d_model), jW._sinusoid(TE, jm.cfg.d_model),
          1e-6, "sinusoid")


def test_decode_seq_and_forward_match(pair):
    """``decode_seq`` on the port's own encoder states against the
    reference's on its own, and ``Model.forward`` (frames in) the same."""
    jm, jp, tm, tp, tol = pair
    frames, tok = inputs(1, tm.cfg.d_model)
    je = jW.encode(jp, jm.cfg, jnp.asarray(frames))
    jl = jW.decode_seq(jp, jm.cfg, jnp.asarray(tok), je)
    te = tW.encode(tp, tm.cfg, torch.from_numpy(frames))
    tl = tW.decode_seq(tp, tm.cfg, torch.from_numpy(tok), te)
    close(tl, jl, tol, "decode_seq logits")
    fl = tm.forward(tp, torch.from_numpy(tok),
                    frames=torch.from_numpy(frames))
    assert torch.equal(fl, tl)
    with pytest.raises(ValueError, match="frames"):
        tm.forward(tp, torch.from_numpy(tok))


def reference_cross_cache(jm, jp, je, max_len):
    """The reference test's prefill-side cross K/V
    (``test_moe_and_models.py::test_whisper_decode_with_cross_kv``)."""
    cfg = jm.cfg
    cache = jm.init_cache(B, max_len)
    xks, xvs = [], []
    for layer in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[layer], jp["dec_layers"])
        k = jL.linear(je, lp["xattn"]["wk"]).reshape(
            B, TE, cfg.n_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
        v = jL.linear(je, lp["xattn"]["wv"]).reshape(
            B, TE, cfg.n_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
        pad = max_len - TE
        xks.append(jnp.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0))))
        xvs.append(jnp.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0))))
    cache["xk"] = jnp.stack(xks).astype(cache["xk"].dtype)
    cache["xv"] = jnp.stack(xvs).astype(cache["xv"].dtype)
    return cache


@pytest.mark.parametrize("packed", [False, True], ids=["baseline", "packed"])
@pytest.mark.parametrize("pad", [0, 8], ids=["full", "padded"])
def test_decode_steps_with_populated_cross_kv_match(pair, packed, pad):
    """Cross K/V from the encoder states (``fill_cross_cache`` against the
    reference test's), then teacher-forced ``decode_step``s against the
    reference's, with ``decode_gqa_packed`` off and on.  With no pad rows
    (max_len = Te) the steps also agree with ``decode_seq`` at the same
    positions; with pad rows the cross attention runs over them unmasked
    in both packages."""
    jm, jp, tm, tp, tol = pair
    frames, tok = inputs(2, tm.cfg.d_model)
    max_len = TE + pad
    je = jW.encode(jp, jm.cfg, jnp.asarray(frames))
    te = tW.encode(tp, tm.cfg, torch.from_numpy(frames))
    jc = reference_cross_cache(jm, jp, je, max_len)
    tc = tW.fill_cross_cache(tp, tm.cfg, tm.init_cache(B, max_len), te)
    for k in ("xk", "xv"):
        close(tc[k], jc[k], tol, f"cross cache {k}")
        assert not tc[k][:, :, :, TE:].any()
    seq = tW.decode_seq(tp, tm.cfg, torch.from_numpy(tok), te)
    steps = TD // 2
    with tflags.use_flags(decode_gqa_packed=packed), \
            jflags.use_flags(decode_gqa_packed=packed):
        jstep = jax.jit(jm.decode_step)
        for t in range(steps):
            col = tok[:, t:t + 1]
            jl, jc = jstep(jp, jc, jnp.asarray(col), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(col), t)
            close(tl, jl, tol, f"step {t}")
            if not pad:
                close(tl[:, 0], seq[:, t], tol, f"step {t} vs decode_seq")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"self-attention cache {k}")


def test_gelu_equals_jax_gelu_bit_for_bit_in_bfloat16():
    """Every finite bfloat16 value through ``layers.gelu`` and through
    ``jax.nn.gelu`` (its default tanh form, jitted and not): equal bit for
    bit but where XLA flushes a subnormal result to zero; and
    ``F.gelu(approximate="tanh")``, which rounds once, is not the same
    function."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    got = tL.gelu(x).float().numpy()
    # where the float32 result before its rounding to bfloat16 is
    # subnormal (XLA flushes it; torch rounds it, up to the smallest
    # normal for some)
    xd = x.double()
    exact = (xd * 0.5 * (1 + torch.tanh(0.7978845608 * (
        xd + 0.044715 * xd ** 3)))).numpy()
    flushed = (np.abs(exact) < np.finfo(np.float32).tiny) & (exact != 0)
    assert flushed.sum() < 1000
    for want in (jax.jit(jax.nn.gelu)(xj), jax.nn.gelu(xj)):
        want = np.asarray(want.astype(jnp.float32))
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        assert same[~flushed].all(), x[torch.from_numpy(~same & ~flushed)][:8]
        assert (want[flushed] == 0).all()
    once = torch.nn.functional.gelu(x, approximate="tanh").float().numpy()
    assert (once != got).sum() > 100


def test_gelu_mlp_matches(monkeypatch):
    """``gelu_mlp`` on numpy draws: bit for bit in bfloat16 (measured)
    and within 1e-6 normwise in float32 (XLA's tanh and torch's part in
    the last float32 bits)."""
    rng = np.random.default_rng(12)
    a = [rng.standard_normal(s).astype(np.float32) * c for s, c in (
        ((3, 7, 32), 1.0), ((32, 64), 32 ** -0.5), ((64,), 0.5),
        ((64, 32), 0.125), ((32,), 0.5))]
    for dt, jdt, tol in ((torch.bfloat16, jnp.bfloat16, 0.0),
                         (torch.float32, jnp.float32, 1e-6)):
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jdt)
        monkeypatch.setattr(tL, "COMPUTE_DTYPE", dt)
        want = jL.gelu_mlp(jnp.asarray(a[0]).astype(jdt),
                           *map(jnp.asarray, a[1:]))
        got = tL.gelu_mlp(torch.from_numpy(a[0]).to(dt),
                          *(torch.from_numpy(t).to(dt) for t in a[1:]))
        if tol == 0.0:
            np.testing.assert_array_equal(f32(got), f32(want))
        else:
            close(got, want, tol, "gelu_mlp float32")


def whisper_requests(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(2, 8))).tolist(),
             int(rng.integers(2, 10))) for _ in range(n)]


@pytest.mark.parametrize("policy", ["ooo", "naive"])
def test_server_serves_whisper_as_the_reference(monkeypatch, policy):
    """The ``Server`` on whisper-base: one position for every slot (the
    largest, as the reference serves a family that is not a transformer),
    every cache leaf of a slot zeroed on admission (the cross K/V
    included): the same tokens, steps and statistics as the JAX
    ``Server`` in float32, at the reference's own draw."""
    jm, jp, tm, tp, _ = make_pair("float32", monkeypatch, width_draw=False)
    reqs = whisper_requests(13, 9)
    jsrv = jserving.Server(jm, jp, n_slots=3, max_len=24, policy=policy)
    tsrv = tserving.Server(tm, tp, n_slots=3, max_len=24, policy=policy)
    assert set(tsrv.cache) == {"k", "v", "xk", "xv"}
    jreqs = [jserving.Request(i, list(p), m) for i, (p, m) in enumerate(reqs)]
    treqs = [tserving.Request(i, list(p), m) for i, (p, m) in enumerate(reqs)]
    for srv, rs in ((jsrv, jreqs), (tsrv, treqs)):
        for r in rs:
            srv.submit(r)
    jst, tst = jsrv.run(), tsrv.run()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.completed == len(reqs) and all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_launcher_serves_whisper_as_the_reference_launcher(capsys,
                                                           monkeypatch):
    """``python -m repro_torch.launch.serve --arch whisper-base --smoke``
    on the CPU completes every request in the reference launcher's steps
    and utilization (its summary line up to the wall clock)."""
    args = ["--arch", ARCH, "--smoke", "--requests", "6", "--slots", "3",
            "--max-len", "32"]
    stats = tlaunch.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jlaunch.main()
    want = capsys.readouterr().out

    def summary(line):
        return [w for w in line.split() if w.split("=")[0] in (
            "policy", "completed", "steps", "utilization")]
    assert stats.completed == 6 and "device=cpu" in got
    assert summary(got) == summary(want) and len(summary(got)) == 4
