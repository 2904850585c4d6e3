"""The port's dense transformer (Qwen2-1.5B's smoke config) held against the
JAX reference on the same parameters.

``cfg.smoke()`` keeps Qwen2-1.5B's family and QKV bias at 2 layers, d_model
128, 4 query heads on 1 KV head, head dim 32, vocab 512.  The JAX model's
parameters (from ``PRNGKey(0)``) are carried across with
``params_from_reference``; tokens come from numpy with a seed.  The JAX
side runs its Pallas ops in interpret mode at T = 64 and 128 (where its
attention is exact, ``test_torch_transformer_kernels.py``) and its plain
ops (``repro.kernels.ops.KERNELS_ENABLED`` False) at a ragged T.

phi3-mini-3.8b's smoke config at its own head dim, 96 (``d_head=96``:
2 layers, d_model 128, 4 heads of 96 without bias), runs the same
``forward``, ``prefill``, ``decode_step`` and ``chunk_step`` checks, with
its weight matrices drawn at 1/sqrt(their input width)
(``reference_params(width_draw=True)``, as ``test_torch_ssm.py`` draws
them): at the reference's draw, without QKV biases, its bfloat16 logits
part from the JAX model's by about the bfloat16 limit itself on some
token draws, at head dims 32 and 64 alike (the floor of that draw, not
of the head dim); at the width draw they sit well inside it.

Tolerance, normwise: the largest absolute difference over the largest
magnitude of the reference array.  In float32, with both packages'
``COMPUTE_DTYPE`` set to float32 here, 1e-4 (measured up to 4.8e-5): the
two frameworks sum the matrix products in different orders (relative 5e-7
on q and k), and the reference's initial scale amplifies that through the
softmax (a stacked weight's fan-in is its layer count, so the attention
logits run to the hundreds).  In bfloat16, 1e-1 (measured up to 3.8e-2,
the decode and chunk steps bit for bit): a sum order that flips one
rounding to 8 bits of mantissa is amplified the same way.  Every op
rounds where the reference's does (``layers.silu`` follows XLA's
expansion of the sigmoid), so the rest is equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.models import transformer as jT

from repro_torch.configs import registry as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as tT
from repro_torch.runtime import flags as tflags

NORM_TOL = {"bfloat16": 1e-1, "float32": 1e-4}
ARCH = "qwen2-1.5b"
PHI3 = "phi3-mini-3.8b"


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pair(dtype, monkeypatch, jcfg, tcfg, width_draw=False):
    """(JAX model, JAX params, port model, port params, tolerance) at the
    two packages' copies of one config, in the compute dtype ``dtype``."""
    if dtype == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)
    jm = jregistry.build(jcfg)
    jp = reference_params(jm, width_draw=width_draw)
    tm = tregistry.build(tcfg, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    return jm, jp, tm, tp, NORM_TOL[dtype]


@pytest.fixture(params=["bfloat16", "float32"])
def pair(request, monkeypatch):
    """The smoke Qwen2-1.5B pair in the compute dtype of the parameter."""
    return make_pair(request.param, monkeypatch,
                     jregistry.build_smoke(ARCH).cfg,
                     tconfigs.get_config(ARCH).smoke())


@pytest.fixture(params=["bfloat16", "float32"])
def phi3_pair(request, monkeypatch):
    """phi3-mini-3.8b's smoke config at head dim 96, the pair in the
    compute dtype of the parameter."""
    return make_pair(
        request.param, monkeypatch,
        dataclasses.replace(jregistry.build_smoke(PHI3).cfg, d_head=96),
        dataclasses.replace(tconfigs.get_config(PHI3).smoke(), d_head=96),
        width_draw=True)


def reference_params(jm, seed=5, width_draw=False):
    """The JAX model's ``PRNGKey(0)`` parameters, with the leaves its
    template starts at zero (the QKV biases) or one (the norm weights)
    drawn from numpy instead, so that the bias adds and the norm weights
    are exercised too.  ``width_draw``: every weight matrix but the
    embedding drawn from numpy at 1/sqrt(its input width) too, as
    ``test_torch_ssm.py`` draws them (the reference's draw takes a stacked
    leaf's fan-in from its layer count)."""
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    if width_draw:
        def leaf(path, a):
            if a.ndim < 2 or "embed" in jax.tree_util.keystr(path):
                return a
            return jnp.asarray(rng.standard_normal(a.shape)
                               / np.sqrt(a.shape[-2]), jnp.float32)
        jp = jax.tree_util.tree_map_with_path(leaf, jp)
    lay = jp["layers"]
    for k in ("bq", "bk", "bv"):
        if k not in lay["attn"]:            # no QKV bias
            continue
        b = lay["attn"][k]
        lay["attn"][k] = jnp.asarray(rng.standard_normal(b.shape) * 0.5,
                                     jnp.float32)
    for k in ("ln1", "ln2"):
        lay[k] = jnp.asarray(1 + 0.2 * rng.standard_normal(lay[k].shape),
                             jnp.float32)
    jp["final_norm"] = jnp.asarray(
        1 + 0.2 * rng.standard_normal(jp["final_norm"].shape), jnp.float32)
    return jp


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: normwise error {err:.3g} > {tol}"


def tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@pytest.mark.parametrize("T", [64, 128, 100])
def test_forward_and_prefill_match(pair, T, monkeypatch):
    forward_and_prefill_match(pair, T, monkeypatch)


@pytest.mark.parametrize("T", [64, 100])
def test_phi3_at_head_dim_96_forward_and_prefill_match(phi3_pair, T,
                                                       monkeypatch):
    forward_and_prefill_match(phi3_pair, T, monkeypatch)


def test_phi3_at_head_dim_96_decode_steps_match(phi3_pair):
    decode_steps_at_one_position_match(phi3_pair)
    decode_steps_at_per_lane_positions_match(phi3_pair)


def test_phi3_at_head_dim_96_chunk_steps_match(phi3_pair):
    chunk_steps_match(phi3_pair)


def forward_and_prefill_match(pair, T, monkeypatch):
    jm, jp, tm, tp, tol = pair
    assert tm.cfg.head_dim == jm.cfg.head_dim
    if T % 64:                       # ragged: the reference's plain ops
        monkeypatch.setattr(jops, "KERNELS_ENABLED", False)
    tok = tokens(T, 2, T)
    jl, jaux = jT.forward(jp, jm.cfg, jnp.asarray(tok))
    tl, taux = tT.forward(tp, tm.cfg, torch.from_numpy(tok))
    assert tl.dtype == tL.COMPUTE_DTYPE and float(jaux) == taux == 0.0
    close(tl, jl, tol, "forward logits")
    jl, jc = jT.prefill(jp, jm.cfg, jnp.asarray(tok), T + 16)
    tl, tc = tT.prefill(tp, tm.cfg, torch.from_numpy(tok), T + 16)
    close(tl, jl, tol, "prefill logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"prefill cache {k}")
        assert not tc[k][:, :, :, T:].any()


def test_decode_steps_at_one_position_match(pair):
    decode_steps_at_one_position_match(pair)


def decode_steps_at_one_position_match(pair):
    """Scalar ``pos``: a prompt fed token by token, the last step past the
    cache, where the reference's ``dynamic_update_slice`` clamps the write
    to the last row."""
    jm, jp, tm, tp, tol = pair
    tok = tokens(1, 2, 12)
    jc, tc = jm.init_cache(2, 10), tm.init_cache(2, 10)
    for t in list(range(10)) + [13]:
        col = tok[:, t % 12:t % 12 + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(col), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(col), t)
        close(tl, jl, tol, f"step {t} logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"cache {k}")


def test_decode_steps_at_per_lane_positions_match(pair):
    decode_steps_at_per_lane_positions_match(pair)


def decode_steps_at_per_lane_positions_match(pair):
    """Per-lane ``pos``: three lanes at different depths; lane 2 runs past
    the cache, where the reference drops the write (and a negative
    position counts from the end)."""
    jm, jp, tm, tp, tol = pair
    tok = tokens(2, 3, 8)
    jc, tc = jm.init_cache(3, 32), tm.init_cache(3, 32)
    offsets = np.asarray([0, 5, 29], np.int32)
    for t in range(6):
        pos = offsets + t
        if t == 5:
            pos[0] = -3
        col = tok[:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(col), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(col),
                                torch.from_numpy(pos))
        close(tl, jl, tol, f"step {t} logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"cache {k}")


def test_chunk_steps_match(pair):
    chunk_steps_match(pair)


def chunk_steps_match(pair):
    """``chunk_step`` after a prefill: a chunk, an overlapping chunk (the
    rollback), and a chunk past the end (a clamped write)."""
    jm, jp, tm, tp, tol = pair
    tok = tokens(3, 1, 20)
    _, jc = jT.prefill(jp, jm.cfg, jnp.asarray(tok[:, :8]), 24)
    _, tc = tT.prefill(tp, tm.cfg, torch.from_numpy(tok[:, :8]), 24)
    for pos, lo in ((8, 8), (10, 12), (22, 16)):
        chunk = tok[:, lo:lo + 4]
        jl, jc = jT.chunk_step(jp, jm.cfg, jc, jnp.asarray(chunk),
                               jnp.int32(pos))
        tl, tc = tT.chunk_step(tp, tm.cfg, tc, torch.from_numpy(chunk), pos)
        close(tl, jl, tol, f"chunk at {pos} logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"cache {k}")


def test_softmax_xent_matches():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        got = tL.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "yi-34b", "phi3-mini-3.8b",
                                  "command-r-plus-104b"])
def test_templates_and_configs_are_the_references(arch):
    """The dense archs' configs are copies, and each template has the
    reference's tree, shapes, logical axes and initializers."""
    jcfg = jregistry.build_arch(arch).cfg
    tcfg = tconfigs.get_config(arch)
    assert repr(tcfg) == repr(jcfg)
    jt = jax.tree_util.tree_flatten_with_path(
        jT.template(jcfg), is_leaf=lambda x: isinstance(x, jL.Spec))[0]
    tt = []

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            tt.append((path, node))
    walk((), tT.template(tcfg))
    assert sorted((tuple(k.key for k in p), (s.shape, s.axes, s.init,
                                             s.scale)) for p, s in jt) == \
        sorted((p, (s.shape, s.axes, s.init, s.scale)) for p, s in tt)
    m = tregistry.build(tcfg, device="cpu")
    assert m.param_count() == jregistry.build(jcfg).param_count()


def test_random_init_follows_the_reference_distribution():
    """Ones, zeros and normal × 1/sqrt(fan-in), where a stacked layer
    tensor's fan-in is its leading layer count, as in the reference; bf16
    on the model's device; the layers split into per-layer views."""
    m = tregistry.build_smoke(ARCH, device="cpu")
    p = m.init(3)
    assert len(p["layers"]) == 2 and p["embed"].dtype == torch.bfloat16
    lp = p["layers"][0]
    assert torch.equal(lp["ln1"], torch.ones(128, dtype=torch.bfloat16))
    assert not lp["attn"]["bq"].any()
    assert abs(float(p["embed"].float().std()) - 1.0) < 0.02
    assert abs(float(lp["mlp"]["w_gate"].float().std()) - 2 ** -0.5) < 0.02
    assert abs(float(p["lm_head"].float().std()) - 128 ** -0.5) < 0.01
    assert torch.equal(m.init(3)["embed"], p["embed"])
    assert not torch.equal(m.init(4)["embed"], p["embed"])


def test_unported_families_and_flags_raise():
    """Every family builds now (whisper-base, the audio family, since
    ROADMAP Queue 1 item 5d; the MoE and VLM families since 5c), and the
    decode flags run (5e): ``decode_kv_int8`` gives the int8 cache and
    ``decode_gqa_packed`` a decode step.  What still raises:
    ``decode_kv_seq_shard``, which is not a flag of the port
    (``TypeError``), and ``prefix_embeds`` given to a family that is not
    the vlm (``ValueError``)."""
    for arch in ("whisper-base", "olmoe-1b-7b", "qwen2-moe-a2.7b",
                 "paligemma-3b"):
        assert tregistry.build_arch(arch, device="cpu").cfg.name == arch
    m = tregistry.build_smoke(ARCH, device="cpu")
    p = m.init(0)
    with tflags.use_flags(decode_kv_int8=True):
        assert m.init_cache(1, 8)["k"].dtype == torch.int8
    c = m.init_cache(1, 8)
    with tflags.use_flags(decode_gqa_packed=True):
        lg, _ = m.decode_step(p, c, torch.zeros(1, 1, dtype=torch.int32), 0)
    assert lg.shape == (1, 1, m.cfg.vocab)
    with tflags.use_flags(moe_grouped=True) as f:
        assert f.moe_grouped and tflags.FLAGS.moe_grouped
    assert not tflags.FLAGS.moe_grouped
    with pytest.raises(TypeError, match="decode_kv_seq_shard"):
        with tflags.use_flags(decode_kv_seq_shard=True):
            pass
    with pytest.raises(ValueError, match="vlm"):
        m.forward(p, torch.zeros(1, 4, dtype=torch.int32),
                  prefix_embeds=torch.zeros(1, 2, 128))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tregistry.build_smoke(ARCH)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_reference({"layers": {}},
                                      tconfigs.get_config(ARCH))
