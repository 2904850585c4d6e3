"""The port's MoE layer and its two families (olmoe-1b-7b, qwen2-moe-a2.7b)
and paligemma-3b's prefix-LM attention, held against the JAX reference on
the same parameters and inputs.

``moe_apply`` is compared on the reference property test's configuration
(d_model 32, the experts padded to 16) at E in {2, 4, 8}, k in {1, 2},
with and without a shared expert, in both dispatches; its parameters are
the reference's ``PRNGKey(seed)`` draw carried across as numpy, its input
numpy's.  In float32 (both ``COMPUTE_DTYPE``s set here) the top-k indices
and the kept assignments are equal, the output within 1e-5 normwise (the
two frameworks sum the expert products in different orders) and ``aux``
within 1e-6 relative (the mean over tokens likewise).  In bfloat16 the
output within 1e-2 normwise (measured: bit for bit).

The smoke models (2 layers, d_model 128, 8 experts padded to 16, top-2,
one shared expert for qwen2-moe; paligemma's 8-token prefix, one KV head)
run on the JAX model's parameters carried by ``params_from_reference``,
the norm weights and QKV biases drawn non-zero and the layers' weight
matrices drawn at 1/sqrt(their input width), as ``test_torch_ssm.py``
draws them (the reference's fan-in, the stacked layer count, makes bf16
comparisons meaningless).  The JAX side runs its Pallas attention in
interpret mode where the key length is at most 128 and its plain ops where
the key length is ragged above 128 (its kernel is NaN there).  Tolerance,
normwise: float32 1e-5 (measured up to 7.8e-7), every routing decision
equal to the reference's; bfloat16 5e-2 (measured up to 9.5e-3), with the
port handed the reference's routing decisions (``Pair.both``: its own
differ at bf16 near-ties, 31 of 10352 measured).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ArchConfig, MoEConfig
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.models import transformer as jT
from repro.runtime import flags as jflags

from repro_torch.configs import base as tbase
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as tT
from repro_torch.runtime import flags as tflags

NORM_TOL = {"bfloat16": 5e-2, "float32": 1e-5}
MOE_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b", "paligemma-3b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def set_dtype(monkeypatch, dtype):
    if dtype == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def normwise(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close(got, want, tol, what=""):
    err = normwise(got, want)
    assert err <= tol, f"{what}: normwise error {err:.3g} > {tol}"


def both(a):
    """The same values in both packages, rounded once to the compute
    dtype."""
    j = jnp.asarray(a).astype(jL.COMPUTE_DTYPE)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        tL.COMPUTE_DTYPE)


def to_torch(tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            tL.COMPUTE_DTYPE), tree)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
def moe_cfgs(E, k, shared, cf=1.25):
    """The reference property test's configuration, in both packages."""
    kw = dict(name="moe-test", family="moe", n_layers=1, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab=64, d_head=16)
    mk = dict(num_experts=E, top_k=k, d_expert=64, num_shared=shared,
              d_shared=64 if shared else 0, capacity_factor=cf)
    return (ArchConfig(**kw, moe=MoEConfig(**mk)),
            tbase.ArchConfig(**kw, moe=tbase.MoEConfig(**mk)))


def reference_slots(topi, E, C):
    """The kept assignments of a (..., n, k) top-k index array, grouped
    over its leading axes: an assignment is kept when fewer than C earlier
    assignments of its group (in token, then rank order) chose its
    expert.  A plain loop, independent of both packages' cumsums."""
    flat = topi.reshape(-1, topi.shape[-2] * topi.shape[-1])
    keep = np.zeros(flat.shape, bool)
    for g, row in enumerate(flat):
        seen = np.zeros(E, int)
        for i, e in enumerate(row):
            keep[g, i] = seen[e] < C
            seen[e] += 1
    return keep.reshape(topi.shape[:-2] + (-1,))


def run_moe(monkeypatch, seed, E, k, shared, grouped, x_np, cf=1.25,
            router_gain=1.0):
    """moe_apply in both packages on the reference's PRNGKey(seed) draw;
    the JAX top-k indices and the port's indices and kept assignments are
    caught on the way."""
    jc, tc = moe_cfgs(E, k, shared, cf)
    jp = jL.init_params(jax.random.PRNGKey(seed), jT.moe_template(jc))
    jp["router"] = jp["router"] * router_gain
    tp = to_torch(jp)
    jx, tx = both(x_np)
    caught = {}
    j_top_k = jax.lax.top_k

    def jax_top_k(a, kk):
        out = j_top_k(a, kk)
        caught["jax"] = np.asarray(out[1])
        return out

    t_slots = tT._slots

    def port_slots(flat_e, E_, C):
        dst, keep = t_slots(flat_e, E_, C)
        caught["port"] = (flat_e.numpy(), keep.numpy(), C)
        return dst, keep

    with monkeypatch.context() as mp, \
            jflags.use_flags(moe_grouped=grouped), \
            tflags.use_flags(moe_grouped=grouped):
        mp.setattr(jax.lax, "top_k", jax_top_k)
        mp.setattr(tT, "_slots", port_slots)
        jy, ja = jT.moe_apply(jp, jc, jx)
        ty, ta = tT.moe_apply(tp, tc, tx)
    return jy, ja, ty, ta, caught


def check_moe(jy, ja, ty, ta, caught, dtype, E, grouped):
    assert ty.shape == tuple(jy.shape) and ty.dtype == tL.COMPUTE_DTYPE
    assert ta.dtype == torch.float32 and ta.dim() == 0
    close(ty, jy, MOE_TOL[dtype], "moe output")
    flat_e, keep, C = caught["port"]
    topi = caught["jax"]
    if dtype == "float32":
        # the port's global dispatch is one group of all the tokens
        groups = topi if grouped else topi.reshape((1,) + topi.shape)
        np.testing.assert_array_equal(
            flat_e, groups.reshape(groups.shape[0], -1))
        np.testing.assert_array_equal(
            keep, reference_slots(groups, tT.padded_experts(E), C))
        assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    else:
        assert float(ta) == pytest.approx(float(ja), rel=1e-4)


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("E,k", [(2, 1), (2, 2), (4, 1), (4, 2), (8, 1),
                                 (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_the_reference(monkeypatch, dtype, E, k, shared,
                                         grouped):
    set_dtype(monkeypatch, dtype)
    x = np.random.default_rng(10 * E + k).standard_normal(
        (3, 8, 32)).astype(np.float32)
    out = run_moe(monkeypatch, E + k, E, k, shared, grouped, x)
    check_moe(*out, dtype, E, grouped)


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("seed", [240, 38097])
def test_moe_apply_matches_the_reference_at_its_property_seeds(
        monkeypatch, seed, grouped):
    """The reference property test's draws at the seeds where its
    ``aux >= 0.99`` fails (ROADMAP Queue 3): the port gives the same
    routing and the same aux."""
    set_dtype(monkeypatch, "float32")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed % 1000),
                                     (2, 8, 32), jnp.float32))
    out = run_moe(monkeypatch, seed, 4, 2, 0, grouped, x)
    check_moe(*out, "float32", 4, grouped)


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_moe_apply_drops_past_capacity_as_the_reference(monkeypatch,
                                                        grouped):
    """Capacity 1 a slot: most assignments drop, and the kept ones are the
    first to reach each expert."""
    set_dtype(monkeypatch, "float32")
    x = np.random.default_rng(5).standard_normal((2, 8, 32)).astype(
        np.float32)
    out = run_moe(monkeypatch, 3, 8, 2, 1, grouped, x, cf=0.01)
    assert out[4]["port"][2] == 1 and not out[4]["port"][1].all()
    check_moe(*out, "float32", 8, grouped)


@pytest.mark.parametrize("probs", [
    [[0.0] * 16],
    [[0.25, 0.25, 0.5] + [0.0] * 13],
    [[0.0, 0.5, 0.0, 0.5] + [0.0] * 12],
    [[0.125] * 8 + [0.0] * 8, [0.0] * 8 + [0.125] * 8],
], ids=["all-zero", "tie-then-zeros", "two-ties", "blocks"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_top_k_breaks_ties_as_jax(probs, k):
    """Exact ties and exact zeros (underflowed probabilities): the lower
    index first, as ``jax.lax.top_k``."""
    a = np.asarray(probs, np.float32)
    gv, gi = tT.top_k(torch.from_numpy(a), k)
    wv, wi = jax.lax.top_k(jnp.asarray(a), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_top_k_on_bf16_rounded_scores_matches_jax():
    """Probabilities rounded to bfloat16 (a few values, many ties) and a
    random draw: the same indices as ``jax.lax.top_k``."""
    rng = np.random.default_rng(7)
    a = rng.choice([0.0, 2 ** -9, 2 ** -3, 0.25], size=(64, 16))
    b = np.array(jnp.asarray(rng.random((64, 16))).astype(jnp.bfloat16)
                 .astype(jnp.float32))
    for p in (a.astype(np.float32), b):
        for k in (1, 2, 8):
            gi = tT.top_k(torch.from_numpy(p), k)[1]
            np.testing.assert_array_equal(
                gi.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(p), k)[1]))


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_moe_apply_with_underflowed_probabilities_matches_the_reference(
        monkeypatch, grouped):
    """A router scaled until the softmax saturates: every unchosen expert's
    probability is exactly 0, so past the winner the top-k picks among
    ties, and those tied picks still take capacity slots."""
    set_dtype(monkeypatch, "float32")
    x = np.random.default_rng(9).standard_normal((2, 8, 32)).astype(
        np.float32)
    out = run_moe(monkeypatch, 11, 8, 2, 0, grouped, x, cf=0.5,
                  router_gain=1e4)
    topi = out[4]["jax"]
    assert (topi[..., 1] < topi[..., 0]).any()      # a zero-prob pick
    check_moe(*out, "float32", 8, grouped)


def test_padded_experts_receive_no_tokens():
    """qwen2-moe's 60 experts pad to 64; the smoke test's 6 to 16: no
    assignment reaches a padded expert, in either dispatch."""
    assert tT.padded_experts(60) == 64 and tT.padded_experts(6) == 16
    _, tc = moe_cfgs(6, 2, 0, 2.0)
    gen = torch.Generator().manual_seed(0)
    p = tL.init_params(gen, tT.moe_template(tc))
    x = torch.randn(2, 16, 32, generator=gen).to(tL.COMPUTE_DTYPE)
    for grouped in (False, True):
        with tflags.use_flags(moe_grouped=grouped):
            probs, _, topi = tT._route(p, tc, x)
            y, aux = tT.moe_apply(p, tc, x)
        assert int(topi.max()) < 6 and not probs[..., 6:].any()
        assert bool(torch.isfinite(y.float()).all()) and math.isfinite(aux)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------
def reference_params(jm, seed=5):
    """The JAX model's ``PRNGKey(0)`` parameters, with the leaves its
    template starts at one (norm weights) or zero (QKV biases) drawn from
    numpy, so that they are exercised too, and the layers' weight matrices
    (experts and router included) redrawn from numpy at 1/sqrt(their input
    width)."""
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    lay = jp["layers"]

    def matrices(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                matrices(v)
            elif v.ndim >= 3 and k not in ("bq", "bk", "bv"):
                tree[k] = jnp.asarray(rng.standard_normal(v.shape)
                                      / math.sqrt(v.shape[-2]), jnp.float32)
    matrices(lay)
    for k in ("bq", "bk", "bv"):
        if k in lay["attn"]:
            b = lay["attn"][k]
            lay["attn"][k] = jnp.asarray(
                rng.standard_normal(b.shape) * 0.5, jnp.float32)
    for k in ("ln1", "ln2"):
        lay[k] = jnp.asarray(1 + 0.2 * rng.standard_normal(lay[k].shape),
                             jnp.float32)
    jp["final_norm"] = jnp.asarray(
        1 + 0.2 * rng.standard_normal(jp["final_norm"].shape), jnp.float32)
    return jp


@dataclasses.dataclass
class Pair:
    jm: object
    jp: dict
    tm: object
    tp: dict
    dtype: str
    mp: pytest.MonkeyPatch

    @property
    def tol(self):
        return NORM_TOL[self.dtype]

    def both(self, jfn, tfn):
        """``jfn()`` and ``tfn()``, the same computation in the two
        packages.  For the MoE families the reference's top-k indices are
        caught, one array a ``moe_apply`` call; in float32 the port's own
        must equal them; in bfloat16 the port is handed them (its own may
        differ at a bf16 near-tie: at most ``BF16_FLIP_SHARE`` of the
        decisions), so that everything past the discrete choice is
        compared at full strength."""
        if not self.tm.cfg.moe:
            return jfn(), tfn()
        # one list for the pair: a jitted jfn keeps the callback of its
        # first trace
        calls = self.__dict__.setdefault("_jax_calls", [])
        calls.clear()
        j_top_k, t_top_k = jax.lax.top_k, tT.top_k

        def catch(a, k):
            out = j_top_k(a, k)
            jax.debug.callback(lambda i: calls.append(np.asarray(i)),
                               out[1], ordered=True)
            return out
        with self.mp.context() as mp:
            mp.setattr(jax.lax, "top_k", catch)
            jout = jfn()
            jax.effects_barrier()
        it, flips, n = iter(calls), [0], [0]

        def route(probs, k):
            own = t_top_k(probs, k)
            want = torch.from_numpy(np.array(next(it))).long().reshape(
                own[1].shape)
            flips[0] += int((own[1] != want).any(-1).sum())
            n[0] += want[..., 0].numel()
            if self.dtype == "float32":
                return own
            return probs.gather(-1, want), want
        with self.mp.context() as mp:
            mp.setattr(tT, "top_k", route)
            tout = tfn()
        assert next(it, None) is None and n[0] > 0
        limit = 0 if self.dtype == "float32" else max(
            1, BF16_FLIP_SHARE * n[0])
        assert flips[0] <= limit, (flips[0], n[0])
        return jout, tout


#: the share of bfloat16 routing decisions (a token in a layer) where the
#: port's own top-k may differ from the reference's, at least one: a
#: last-bit difference upstream flips a near-tie of bf16 scores (measured:
#: 31 of 10352 decisions over this file's model tests, at most 5 of 600 in
#: one forward and 1 of 6 in one decode step)
BF16_FLIP_SHARE = 0.02


@pytest.fixture(params=[(a, d) for a in ARCHS
                        for d in ("bfloat16", "float32")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request, monkeypatch):
    arch, dtype = request.param
    set_dtype(monkeypatch, dtype)
    jm = jregistry.build_smoke(arch)
    jp = reference_params(jm)
    tm = tregistry.build_smoke(arch, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    return Pair(jm, jp, tm, tp, dtype, monkeypatch)


def tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def prefix(cfg, seed, B):
    """paligemma's image prefix (B, P, D) drawn with numpy, else None."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)


def as_jax(a):
    return None if a is None else jnp.asarray(a)


def as_torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("T", [56, 150])
def test_forward_and_prefill_match(pair, T, monkeypatch):
    """forward (logits and aux) and prefill (logits and cache); the vlm
    with its prefix (8 + T positions: its text call's key length is 64,
    or 158, ragged above 128, on JAX's plain route)."""
    cfg, tol = pair.tm.cfg, pair.tol
    pre = prefix(cfg, T, 2)
    Tk = T + (0 if pre is None else pre.shape[1])
    if Tk > 128:                      # ragged: the reference's plain ops
        monkeypatch.setattr(jops, "KERNELS_ENABLED", False)
    tok = tokens(T, 2, T)
    (jl, jaux), (tl, taux) = pair.both(
        lambda: jT.forward(pair.jp, cfg, jnp.asarray(tok), as_jax(pre)),
        lambda: tT.forward(pair.tp, cfg, torch.from_numpy(tok),
                           as_torch(pre)))
    assert tl.shape == (2, Tk, cfg.vocab)
    close(tl, jl, tol, "forward logits")
    if cfg.moe:
        rel = 1e-6 if pair.dtype == "float32" else 1e-2
        assert float(taux) == pytest.approx(float(jaux), rel=rel)
    else:
        assert taux == 0.0 == float(jaux)
    (jl, jc), (tl, tc) = pair.both(
        lambda: jT.prefill(pair.jp, cfg, jnp.asarray(tok), Tk + 16,
                           as_jax(pre)),
        lambda: pair.tm.prefill(pair.tp, torch.from_numpy(tok), Tk + 16,
                                as_torch(pre)))
    close(tl, jl, tol, "prefill logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], tol, f"prefill cache {k}")
        assert not tc[k][:, :, :, Tk:].any()


def test_model_forward_is_the_family_forward(pair):
    """``Model.forward`` (the vlm's with its prefix) returns the module's
    logits."""
    cfg = pair.tm.cfg
    tok = torch.from_numpy(tokens(4, 2, 24))
    pre = as_torch(prefix(cfg, 4, 2))
    assert torch.equal(pair.tm.forward(pair.tp, tok, pre),
                       tT.forward(pair.tp, cfg, tok, pre)[0])


def test_decode_steps_at_per_lane_positions_match(pair):
    """Three lanes at different depths (lane 2 past the cache, a negative
    position in the last step): the MoE routes all lanes together, so the
    lanes share capacity as in the reference."""
    tok = tokens(2, 3, 8)
    jc, tc = pair.jm.init_cache(3, 32), pair.tm.init_cache(3, 32)
    offsets = np.asarray([0, 5, 29], np.int32)
    step = jax.jit(pair.jm.decode_step)          # one trace for the steps
    for t in range(6):
        pos = offsets + t
        if t == 5:
            pos[0] = -3
        col = tok[:, t:t + 1]
        (jl, jc), (tl, tc) = pair.both(
            lambda: step(pair.jp, jc, jnp.asarray(col), jnp.asarray(pos)),
            lambda: pair.tm.decode_step(pair.tp, tc, torch.from_numpy(col),
                                        torch.from_numpy(pos)))
        close(tl, jl, pair.tol, f"step {t} logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], pair.tol, f"cache {k}")


def test_chunk_steps_match(pair):
    """``chunk_step`` after a prefill (the vlm's with its prefix): a chunk,
    an overlapping chunk (the rollback) and a clamped one."""
    cfg = pair.tm.cfg
    tok = tokens(3, 1, 20)
    pre = prefix(cfg, 3, 1)
    P = 0 if pre is None else pre.shape[1]
    (_, jc), (_, tc) = pair.both(
        lambda: jT.prefill(pair.jp, cfg, jnp.asarray(tok[:, :8]), P + 24,
                           as_jax(pre)),
        lambda: pair.tm.prefill(pair.tp, torch.from_numpy(tok[:, :8]),
                                P + 24, as_torch(pre)))
    step = jax.jit(lambda c, x, pos: jT.chunk_step(pair.jp, cfg, c, x, pos))
    for pos, lo in ((P + 8, 8), (P + 10, 12), (P + 22, 16)):
        chunk = tok[:, lo:lo + 4]
        (jl, jc), (tl, tc) = pair.both(
            lambda: step(jc, jnp.asarray(chunk), jnp.int32(pos)),
            lambda: pair.tm.chunk_step(pair.tp, tc, torch.from_numpy(chunk),
                                       pos))
        close(tl, jl, pair.tol, f"chunk at {pos} logits")
    for k in ("k", "v"):
        close(tc[k], jc[k], pair.tol, f"cache {k}")


def test_grouped_dispatch_matches_the_reference_in_the_model(monkeypatch):
    """olmoe's smoke model on ``FLAGS.moe_grouped`` in float32: forward
    logits and aux as the reference's under the same flag, every routing
    decision equal."""
    set_dtype(monkeypatch, "float32")
    jm = jregistry.build_smoke("olmoe-1b-7b")
    jp = reference_params(jm)
    tm = tregistry.build_smoke("olmoe-1b-7b", device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    pair = Pair(jm, jp, tm, tp, "float32", monkeypatch)
    tok = tokens(6, 2, 64)
    with jflags.use_flags(moe_grouped=True), \
            tflags.use_flags(moe_grouped=True):
        (jl, ja), (tl, ta) = pair.both(
            lambda: jT.forward(jp, jm.cfg, jnp.asarray(tok)),
            lambda: tT.forward(tp, tm.cfg, torch.from_numpy(tok)))
    close(tl, jl, pair.tol, "grouped forward logits")
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)


def leaves(tree, path=()):
    """(path, leaf) of a tree of dicts, in the dicts' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_the_new_families(arch):
    """The MoE tree (experts on E inside each layer, qwen2-moe's shared
    block) and the vlm's: every leaf of the port's template holds the
    reference's values rounded once to bfloat16, the layers split into
    per-layer views of the template's shapes."""
    jm = jregistry.build_smoke(arch)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = tregistry.build_smoke(arch, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")

    def rounded(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    want = dict(leaves(tm.template))
    assert {p for p, _ in leaves(jp)} == set(want)
    assert len(tp["layers"]) == tm.cfg.n_layers
    for path, spec in want.items():
        if path[0] == "layers":
            for i, lp in enumerate(tp["layers"]):
                t = at(lp, path[1:])
                assert tuple(t.shape) == spec.shape[1:], path
                np.testing.assert_array_equal(
                    t.float().numpy(), rounded(at(jp, path)[i]))
        else:
            t = at(tp, path)
            assert tuple(t.shape) == spec.shape, path
            np.testing.assert_array_equal(t.float().numpy(),
                                          rounded(at(jp, path)))
        assert t.dtype == torch.bfloat16
    if tm.cfg.moe:
        E = tT.padded_experts(tm.cfg.moe.num_experts)
        assert tp["layers"][0]["moe"]["w_gate"].shape == (
            E, tm.cfg.d_model, tm.cfg.moe.d_expert)
        assert ("shared" in tp["layers"][0]["moe"]) == bool(
            tm.cfg.moe.num_shared)


@pytest.mark.parametrize("arch", ARCHS)
def test_templates_counts_and_configs_are_the_references(arch):
    """The configs are copies; each template has the reference's tree,
    shapes, logical axes and initializers; total and active parameter
    counts equal the reference's, at full size and smoke size."""
    jm, tm = jregistry.build_arch(arch), tregistry.build_arch(arch,
                                                              device="cpu")
    assert repr(tm.cfg) == repr(jm.cfg)
    jt = jax.tree_util.tree_flatten_with_path(
        jm.template, is_leaf=lambda x: isinstance(x, jL.Spec))[0]
    tt = []

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            tt.append((path, node))
    walk((), tm.template)
    assert sorted((tuple(k.key for k in p), (s.shape, s.axes, s.init,
                                             s.scale)) for p, s in jt) == \
        sorted((p, (s.shape, s.axes, s.init, s.scale)) for p, s in tt)
    for j, t in ((jm, tm), (jregistry.build_smoke(arch),
                            tregistry.build_smoke(arch, device="cpu"))):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_prefix_embeds_belong_to_the_vlm():
    for arch in ("olmoe-1b-7b", "qwen2-1.5b"):
        m = tregistry.build_smoke(arch, device="cpu")
        with pytest.raises(ValueError, match="vlm"):
            m.forward({}, torch.zeros(1, 4, dtype=torch.int32),
                      torch.zeros(1, 2, 128))
        with pytest.raises(ValueError, match="vlm"):
            m.prefill({}, torch.zeros(1, 4, dtype=torch.int32), 8,
                      torch.zeros(1, 2, 128))


def test_prefix_lm_attention_is_bidirectional_over_the_prefix_only():
    """The two K15 calls a layer: a prefix query sees every prefix key
    (a later prefix key moves it) and no text key; a text query sees the
    whole prefix and the text up to itself."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 12, 32, generator=gen) for _ in range(3))
    P = 5
    base = tT.prefix_attention(q, k, v, P)
    for pos, moves in ((3, range(0, 12)), (4, range(0, 12)),
                       (9, range(0, 12))):
        k2 = k.clone()
        k2[:, :, pos] += 1.0
        out = tT.prefix_attention(q, k2, v, P)
        changed = {i for i in moves
                   if not torch.equal(out[:, :, i], base[:, :, i])}
        if pos < P:     # a prefix key: every prefix query and all text
            assert changed == set(range(12))
        else:           # a text key: the text queries at or after it
            assert changed == set(range(pos, 12))
