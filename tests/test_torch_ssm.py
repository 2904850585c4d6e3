"""The port's ssm and hybrid families (rwkv6-3b, zamba2-7b) and their
recurrences K17 ``wkv6`` and K18 ``ssd``, held against the JAX reference
on the same inputs.

Plain recurrences: the port's ``ref.rwkv6_scan``/``ref.mamba2_ssd``, its
wrappers on CPU tensors (``kernels/rwkv6.wkv6`` on the flattened (BH, T,
K) layout, ``kernels/mamba2.ssd``) and its ops, against the JAX Pallas
ops in interpret mode and JAX's ``ref``, at the JAX tests' parameter sets
(``tests/test_kernels_transformer.py``, ragged T included), on inputs
drawn from numpy as those tests draw them (w in (0.5, 1), a <= 0).
Tolerance: float32 1e-5 normwise (largest difference over the largest
reference magnitude; measured up to 3.4e-7, the two frameworks' sums in
other orders); bfloat16 ``allclose`` at rtol = atol = 2e-2, about one
output ulp (measured at most one ulp).

Models: rwkv6-3b's and zamba2-7b's smoke configs (zamba2: one group, no
tail) and zamba2 at 5 layers with period 2 (two groups alternating the two
shared blocks, then a one-layer tail), with the JAX model's parameters
carried by ``params_from_reference``.  Every leaf the template starts at
zero (``w0``, ``a_log``, ``dt_bias``, the mixes, biases and skips) is
drawn non-zero and every norm weight perturbed, so the float32 leaves and
every add are exercised; the weight matrices are drawn at 1/sqrt(their
input width).  The reference's own draw takes a stacked leaf's fan-in
from its leading (layer or group) axis: at one group that is a scale of 1,
activations in the millions, and a bfloat16 sum-order flip in one matrix
product carries to 0.5 of the logits.  Every op is checked to round where
the reference's does (``layers.sigmoid``, ``layers.silu``,
``layers.softplus``), so what is left is the products' sum order:
tolerance, normwise, float32 1e-5 (both ``COMPUTE_DTYPE``s set; measured
up to 4.3e-6) and bfloat16 1e-1 (measured up to 5e-2).  ``forward`` runs
at T = 64 and at a ragged 40; decode steps at a scalar position, as the
reference's ``Server`` steps these families.

``forward`` against token-by-token ``decode_step`` in float32 at 1e-3 (the
reference's own check, ``tests/test_arch_smoke.py``).  The port's
``Server`` against the JAX ``Server`` on equal-length requests, in
float32: the same tokens and statistics.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jconfigs
from repro.core.sched import serving as jserving
from repro.kernels import mamba2 as jmamba2
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rwkv6 as jrwkv6
from repro.models import layers as jL
from repro.models import registry as jregistry

from repro_torch.configs import registry as tconfigs
from repro_torch.core.sched import serving as tserving
from repro_torch.kernels import mamba2 as tmamba2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6 as trwkv6
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry

KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-5, "bfloat16": 1e-1}
#: (arch, config changes): the smoke configs, and zamba2 with two groups
#: and a tail
CONFIGS = [("rwkv6-3b", {}), ("zamba2-7b", {}),
           ("zamba2-7b", {"n_layers": 5, "shared_attn_period": 2})]
CONFIG_IDS = ["rwkv6", "zamba2", "zamba2-5"]
RWKV_SHAPES = [(1, 64, 2, 32, 32), (2, 128, 4, 64, 64), (1, 96, 1, 64, 128)]
SSD_SHAPES = [(1, 64, 2, 32, 16), (2, 128, 4, 64, 64), (1, 80, 3, 16, 32)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def normwise(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close_kernel(got, want, dtype, what=""):
    """float32: normwise; bfloat16: allclose at rtol = atol (one ulp)."""
    tol = KERNEL_TOL[dtype]
    if dtype == "float32":
        err = normwise(got, want)
        assert err <= tol, f"{what}: normwise error {err:.3g} > {tol}"
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol,
                                   err_msg=what)


def torch_of(a, dtype):
    return torch.from_numpy(f32(a)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# plain K17 and K18 against the JAX ops
# ---------------------------------------------------------------------------
def rwkv_inputs(shape, dtype, seed=0):
    """r, k, v, w, u as the JAX test draws them, in ``dtype`` (JAX)."""
    b, t, h, kd, vd = shape
    rng = np.random.default_rng(seed)

    def f(*s, sc=1.0):
        return jnp.asarray(rng.standard_normal(s) * sc,
                           jnp.float32).astype(dtype)

    r, k, v = f(b, t, h, kd, sc=0.5), f(b, t, h, kd, sc=0.5), \
        f(b, t, h, vd, sc=0.5)
    w = (jnp.asarray(1 / (1 + np.exp(-rng.standard_normal((b, t, h, kd)))),
                     jnp.float32) * 0.5 + 0.5).astype(dtype)
    return r, k, v, w, f(h, kd, sc=0.3)


def ssd_inputs(shape, dtype, seed=1):
    """x, a (float32, <= 0), b, c as the JAX test draws them."""
    b, t, h, p, n = shape
    rng = np.random.default_rng(seed)

    def f(*s):
        return jnp.asarray(rng.standard_normal(s) * 0.5, jnp.float32)

    x, a = f(b, t, h, p).astype(dtype), -jnp.abs(f(b, t, h))
    return x, a, f(b, t, n).astype(dtype), f(b, t, n).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_plain_rwkv6_scan_matches_the_reference(shape, dtype):
    """The port's op (heads flattened, its wrapper's CPU route) and its
    plain version against JAX's Pallas op and its ``ref``."""
    jin = rwkv_inputs(shape, getattr(jnp, dtype))
    tin = [torch_of(a, dtype) for a in jin]
    pallas, plain = jops.rwkv6_scan(*jin), jref.rwkv6_scan(*jin)
    for name, got in (("ops", tops.rwkv6_scan(*tin)),
                      ("ref", tref.rwkv6_scan(*tin))):
        assert got.dtype == tin[0].dtype
        close_kernel(got, pallas, dtype, f"{name} vs Pallas")
        close_kernel(got, plain, dtype, f"{name} vs ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_wkv6_wrapper_matches_the_reference_kernel(shape, dtype):
    """K17's wrapper on (BH, T, K) rows, the Pallas kernel's own layout,
    against ``repro.kernels.rwkv6.wkv6`` in interpret mode."""
    b, t, h, kd, vd = shape
    r, k, v, w, u = rwkv_inputs(shape, getattr(jnp, dtype), seed=2)

    def flat(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, t, -1)

    jin = [flat(r), flat(k), flat(v), flat(w), jnp.tile(u, (b, 1))]
    want = jrwkv6.wkv6(*jin)
    got = trwkv6.wkv6(*[torch_of(a, dtype) for a in jin], chunk=16)
    close_kernel(got, want, dtype, "wkv6")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_plain_mamba2_ssd_matches_the_reference(shape, dtype):
    """The port's op, its wrapper and its plain version against JAX's
    Pallas ``ssd`` and its ``ref``; a stays float32 (the model path's)."""
    x, a, b, c = ssd_inputs(shape, getattr(jnp, dtype))
    tin = (torch_of(x, dtype), torch_of(a, "float32"), torch_of(b, dtype),
           torch_of(c, dtype))
    pallas, plain = jmamba2.ssd(x, a, b, c), jref.mamba2_ssd(x, a, b, c)
    close_kernel(jops.mamba2_ssd(x, a, b, c), pallas, dtype, "JAX ops")
    for name, got in (("ops", tops.mamba2_ssd(*tin)),
                      ("wrapper", tmamba2.ssd(*tin, chunk=16)),
                      ("ref", tref.mamba2_ssd(*tin))):
        assert got.dtype == tin[0].dtype
        close_kernel(got, pallas, dtype, f"{name} vs Pallas")
        close_kernel(got, plain, dtype, f"{name} vs ref")


#: the chunked mirror's cases (T, chunk, decay): one step, ragged and whole
#: chunks, and a steep decay (a ≈ −5 a step, where exp(A_i − A_j) for
#: j > i overflows unless masked before the exp)
CHUNKED_CASES = [(t, ch, "drawn") for t in (1, 63, 64, 65, 200)
                 for ch in (16, 64)] + [(200, 64, "steep")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,chunk,decay", CHUNKED_CASES)
def test_plain_chunked_ssd_matches_the_reference(t, chunk, decay, dtype):
    """``ref.mamba2_ssd_chunked`` (the K18 kernel's three steps in plain
    torch) against the port's step-by-step ``ref.mamba2_ssd`` and JAX's
    Pallas ``ssd`` at the same chunk (interpret mode): finite, float32
    within 1e-5 normwise, bfloat16 within 2e-2."""
    shape = (2, t, 3, 16, 32)
    x, a, b, c = ssd_inputs(shape, getattr(jnp, dtype), seed=3)
    if decay == "steep":
        rng = np.random.default_rng(4)
        a = jnp.asarray(-5.0 + 0.1 * rng.standard_normal(shape[:3]),
                        jnp.float32)
    tin = (torch_of(x, dtype), torch_of(a, "float32"), torch_of(b, dtype),
           torch_of(c, dtype))
    got = tref.mamba2_ssd_chunked(*tin, chunk=chunk)
    assert got.dtype == tin[0].dtype and bool(torch.isfinite(got).all())
    close_kernel(got, tref.mamba2_ssd(*tin), dtype, "chunked vs ref")
    close_kernel(got, jmamba2.ssd(x, a, b, c, chunk=chunk), dtype,
                 "chunked vs Pallas")


def test_recurrence_wrappers_refuse_what_they_do_not_take():
    r = torch.zeros(2, 8, 16)
    with pytest.raises(TypeError, match="float64"):
        trwkv6.wkv6(*[r.double()] * 4, torch.zeros(2, 16).double())
    with pytest.raises(ValueError, match="u has shape"):
        trwkv6.wkv6(r, r, r, r, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="contiguous"):
        trwkv6.wkv6(r, r, r, r.transpose(0, 1).contiguous().transpose(0, 1),
                    torch.zeros(2, 16))
    x, b = torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 16)
    with pytest.raises(TypeError, match="a has dtype"):
        tmamba2.ssd(x, torch.zeros(1, 8, 2, dtype=torch.bfloat16), b, b)
    with pytest.raises(TypeError, match="b has dtype"):
        tmamba2.ssd(x, torch.zeros(1, 8, 2), b.bfloat16(), b)


# ---------------------------------------------------------------------------
# the two models against the reference
# ---------------------------------------------------------------------------
def configs(arch, changes):
    return (dataclasses.replace(jconfigs.get_config(arch).smoke(), **changes),
            dataclasses.replace(tconfigs.get_config(arch).smoke(), **changes))


def reference_params(jm, seed=1):
    """The JAX model's ``PRNGKey(0)`` tree with every zero-started leaf
    drawn non-zero (0.5 N), every one-started leaf perturbed (1 + 0.2 N),
    and every weight matrix but the embedding drawn at 1/sqrt(its input
    width) from numpy (module docstring)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if not a.any():
            return jnp.asarray(rng.standard_normal(a.shape) * 0.5,
                               jnp.float32)
        if np.all(a == 1):
            return jnp.asarray(1 + 0.2 * rng.standard_normal(a.shape),
                               jnp.float32)
        if a.ndim >= 2 and "embed" not in jax.tree_util.keystr(path):
            return jnp.asarray(rng.standard_normal(a.shape)
                               / np.sqrt(a.shape[-2]), jnp.float32)
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, jm.init(
        jax.random.PRNGKey(0)))


def build_pair(arch, changes):
    jcfg, tcfg = configs(arch, changes)
    jm = jregistry.build(jcfg)
    jp = reference_params(jm)
    tm = tregistry.build(tcfg, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    return jm, jp, tm, tp


def set_float32(monkeypatch):
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(params=["bfloat16", "float32"])
def dtype(request, monkeypatch):
    if request.param == "float32":
        set_float32(monkeypatch)
    return request.param


def tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def jax_forward(jm, jp, tok):
    from repro.models import rwkv6, zamba2
    fwd = rwkv6.forward if jm.cfg.family == "ssm" else zamba2.forward
    logits, aux = fwd(jp, jm.cfg, jnp.asarray(tok))
    assert float(aux) == 0.0
    return logits


@pytest.mark.parametrize("T", [64, 40])
@pytest.mark.parametrize("arch,changes", CONFIGS, ids=CONFIG_IDS)
def test_forward_matches(arch, changes, T, dtype):
    """``Model.forward`` (the port's kernels route, plain on the CPU)
    against the reference's ``forward`` (its Pallas ops, interpret mode)."""
    jm, jp, tm, tp = build_pair(arch, changes)
    tok = tokens(T, 2, T)
    got = tm.forward(tp, torch.from_numpy(tok))
    assert got.dtype == tL.COMPUTE_DTYPE
    err = normwise(got, jax_forward(jm, jp, tok))
    assert err <= MODEL_TOL[dtype], f"forward logits: {err:.3g}"


@pytest.mark.parametrize("arch,changes", CONFIGS, ids=CONFIG_IDS)
def test_decode_steps_match(arch, changes, dtype):
    """Six ``decode_step``s at a scalar position: each step's logits and
    the final cache, leaf by leaf (the port writes it in place)."""
    jm, jp, tm, tp = build_pair(arch, changes)
    tok = tokens(7, 2, 6)
    jc, tc = jm.init_cache(2, 8), tm.init_cache(2, 8)
    assert set(tc) == set(jc) == set(tm.cache_axes)
    for t in range(6):
        col = tok[:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(col), jnp.int32(t))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(col), t)
        assert tc2 is tc
        err = normwise(tl, jl)
        assert err <= MODEL_TOL[dtype], f"step {t} logits: {err:.3g}"
    for k in jc:
        assert str(tc[k].dtype) == f"torch.{jc[k].dtype}", k
        err = normwise(tc[k], jc[k])
        assert err <= MODEL_TOL[dtype], f"cache {k}: {err:.3g}"


@pytest.mark.parametrize("arch,changes", CONFIGS, ids=CONFIG_IDS)
def test_forward_equals_token_by_token_decode(arch, changes, monkeypatch):
    """The sequence path (K17/K18's route) against stepping the state one
    token at a time, in float32 at 1e-3, the reference's own check; on the
    port's own random parameters."""
    set_float32(monkeypatch)
    m = tregistry.build(configs(arch, changes)[1], device="cpu")
    p = m.init(3)
    tok = torch.from_numpy(tokens(9, 2, 12))
    seq = m.forward(p, tok)
    cache = m.init_cache(2, 12)
    steps = [m.decode_step(p, cache, tok[:, t:t + 1], t)[0][:, 0]
             for t in range(12)]
    torch.testing.assert_close(torch.stack(steps, 1), seq, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("arch,changes", CONFIGS, ids=CONFIG_IDS)
def test_float32_leaves_stay_float32(arch, changes):
    """``w0``, ``a_log`` and ``dt_bias`` are held in float32, carried
    exactly; every other leaf is the bfloat16 cast, from ``init`` and from
    ``params_from_reference`` alike; the stacked subtrees are lists."""
    jm, jp, tm, tp = build_pair(arch, changes)
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    names = {k.rsplit("'", 2)[-2] for k in jflat}
    assert names & tm.impl.FLOAT32_LEAVES
    for params in (tp, tm.init(0)):
        seen = []

        def walk(node, name=""):
            if isinstance(node, (dict, list)):
                items = node.items() if isinstance(node, dict) else \
                    [(name, v) for v in node]
                for k, v in items:
                    walk(v, k)
            else:
                want = torch.float32 if name in tm.impl.FLOAT32_LEAVES \
                    else torch.bfloat16
                assert node.dtype == want, (name, node.dtype)
                seen.append(name)
        walk(params)
        assert set(seen) == names
    period = jm.cfg.shared_attn_period
    if jm.cfg.family == "hybrid":
        g = jp["groups"]
        assert len(tp["groups"]) == g["ln"].shape[0]
        assert all(len(grp) == period for grp in tp["groups"])
        assert len(tp["shared"]) == jm.cfg.n_shared_blocks
        assert len(tp.get("tail", [])) == jm.cfg.n_layers % period
        lp, want = tp["groups"][-1][1], jax.tree.map(lambda a: a[-1, 1], g)
    else:
        assert len(tp["layers"]) == jm.cfg.n_layers
        lp, want = tp["layers"][-1], jax.tree.map(lambda a: a[-1],
                                                  jp["layers"])
    for name in tm.impl.FLOAT32_LEAVES:
        sub = lp.get("att", lp) if name == "w0" else lp
        wsub = want.get("att", want) if name == "w0" else want
        if name in sub:
            assert np.any(sub[name].numpy() != 0)
            np.testing.assert_array_equal(sub[name].numpy(),
                                          np.asarray(wsub[name]))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_templates_and_configs_are_the_references(arch):
    """The configs are copies; the templates have the reference's tree,
    shapes, logical axes and initializers; the parameter counts agree."""
    from repro.models import rwkv6 as jR, zamba2 as jZ
    from repro_torch.models import rwkv6 as tR, zamba2 as tZ
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert repr(tcfg) == repr(jcfg)
    jt_fn, tt_fn = (jR.template, tR.template) if arch == "rwkv6-3b" else \
        (jZ.template, tZ.template)
    jt = jax.tree_util.tree_flatten_with_path(
        jt_fn(jcfg), is_leaf=lambda x: isinstance(x, jL.Spec))[0]
    tt = []

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            tt.append((path, node))
    walk((), tt_fn(tcfg))
    assert sorted((tuple(k.key for k in p), (s.shape, s.axes, s.init,
                                             s.scale)) for p, s in jt) == \
        sorted((p, (s.shape, s.axes, s.init, s.scale)) for p, s in tt)
    m = tregistry.build(tcfg, device="cpu")
    assert m.param_count() == jregistry.build(jcfg).param_count()
    assert m.cache_axes == jregistry.build(jcfg).cache_axes


def test_dense_only_entry_points_raise():
    m = tregistry.build_smoke("zamba2-7b", device="cpu")
    tok = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="prefill"):
        m.prefill({}, tok, 8)
    with pytest.raises(NotImplementedError, match="chunk_step"):
        m.chunk_step({}, {}, tok, 0)


# ---------------------------------------------------------------------------
# the Server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_server_matches_the_reference_server(arch, monkeypatch):
    """Equal-length prompts (the reference's condition for these
    families), more requests than slots: the same tokens, steps and
    statistics as the JAX ``Server``."""
    set_float32(monkeypatch)
    jm, jp, tm, tp = build_pair(arch, {})
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 512, 5).tolist(), int(rng.integers(3, 7)))
            for _ in range(6)]
    jsrv = jserving.Server(jm, jp, n_slots=3, max_len=16)
    tsrv = tserving.Server(tm, tp, n_slots=3, max_len=16)
    jreqs = [jserving.Request(i, list(p), n) for i, (p, n) in enumerate(reqs)]
    treqs = [tserving.Request(i, list(p), n) for i, (p, n) in enumerate(reqs)]
    for srv, rs in ((jsrv, jreqs), (tsrv, treqs)):
        for r in rs:
            srv.submit(r)
    jst, tst = jsrv.run(), tsrv.run()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.completed == len(reqs) and all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_reset_slot_cache_zeroes_only_its_lane():
    """zamba2's conv and ssd leaves are (n_groups, period, B, ...): the
    lane is axis 2 there and axis 1 elsewhere (``cache_axes``)."""
    m = tregistry.build(configs("zamba2-7b", {"n_layers": 5,
                                              "shared_attn_period": 2})[1],
                        device="cpu")
    srv = tserving.Server(m, m.init(0), n_slots=3, max_len=8)
    for leaf in srv.cache.values():
        leaf.fill_(1)
    srv._reset_slot_cache(1)
    for name, leaf in srv.cache.items():
        b = m.cache_axes[name].index("cache_batch")
        assert not leaf.select(b, 1).any(), name
        assert bool((leaf.select(b, 0) == 1).all()), name
        assert bool((leaf.select(b, 2) == 1).all()), name


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_launcher_serves_the_smoke_model_on_the_cpu(arch, capsys):
    stats = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "5", "--slots", "2"])
    assert stats.completed == 5
    assert "completed=5" in capsys.readouterr().out
