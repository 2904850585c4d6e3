"""Training on the port held against the JAX reference, on the CPU.

Every family's smoke config (dense qwen2-1.5b, moe olmoe-1b-7b, vlm
paligemma-3b, ssm rwkv6-3b, hybrid zamba2-7b, audio whisper-base) takes
one ``make_train_step`` from the same state on the same batch in both
packages: the reference's ``{"params", "opt"}`` carried across with
``convert.state_from_reference``, tokens from ``SyntheticLM``.  The JAX
side runs its plain ops (``repro.kernels.ops.KERNELS_ENABLED`` False):
its kernels' gradients are those ops' VJPs, as the port's are.  Each
(family, dtype) is computed once (one JAX compile) and read by three
tests: the loss, the gradients, the updated masters.

Weights are drawn as ``test_torch_ssm.py`` draws them: every matrix but
the embedding at 1/sqrt(its input width), zero-started leaves 0.5·N,
one-started ones 1 + 0.2·N (at the reference's draw the bfloat16
activations of these random models are too large to compare).  AdamW's
state starts at step 5 with drawn moments, so that the update is not a
step-0 no-op (the schedule's warm-up makes lr 0 there); ``v`` is drawn
in [0.5e-6, 1.5e-6): AdamW's update divides by sqrt(v), and at v near 0
it turns a gradient's last-bit difference into an update of lr's size.

Tolerances: float32 loss within 1e-5 relative, each gradient leaf within
1e-4 normwise (largest difference over the largest reference magnitude),
each updated master within 1e-5 normwise; bfloat16 loss within 1e-2
relative and gradients within 1e-1 (``NORM_TOL`` of
``test_torch_models.py``).  The two frameworks sum in other orders; the
global norm sums the leaves in another order too (JAX: sorted keys,
layers stacked).
"""
import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jconfigs
from repro.data import pipeline as jdata
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.runtime import train as jtrain

from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as tconfigs
from repro_torch.data import pipeline as data_lib
from repro_torch.kernels import attention as tattention
from repro_torch.kernels import mamba2 as tmamba2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.kernels import rwkv6 as trwkv6
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry
from repro_torch.optim import adamw, schedule
from repro_torch.runtime import train as train_rt

FAMILIES = {"dense": "qwen2-1.5b", "moe": "olmoe-1b-7b",
            "vlm": "paligemma-3b", "ssm": "rwkv6-3b", "hybrid": "zamba2-7b",
            "audio": "whisper-base"}
TOL = {"float32": dict(loss=1e-5, grads=1e-4, masters=1e-5),
       "bfloat16": dict(loss=1e-2, grads=1e-1)}
B, T, FRAMES = 2, 32, 16
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def compute_dtype(dtype):
    """Both packages' ``COMPUTE_DTYPE`` set to ``dtype`` and the JAX ops
    on their plain route, restored on exit."""
    saved = jL.COMPUTE_DTYPE, tL.COMPUTE_DTYPE, jops.KERNELS_ENABLED
    jL.COMPUTE_DTYPE = getattr(jnp, dtype)
    tL.COMPUTE_DTYPE = getattr(torch, dtype)
    jops.KERNELS_ENABLED = False
    try:
        yield
    finally:
        jL.COMPUTE_DTYPE, tL.COMPUTE_DTYPE, jops.KERNELS_ENABLED = saved


def reference_state(jm, seed=1):
    """The JAX model's ``PRNGKey(0)`` parameters redrawn as the module
    docstring says, with AdamW's moments drawn at step 5."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if not a.any():
            return rng.standard_normal(a.shape).astype(np.float32) * 0.5
        if np.all(a == 1):
            return (1 + 0.2 * rng.standard_normal(a.shape)).astype(
                np.float32)
        if a.ndim >= 2 and "embed" not in jax.tree_util.keystr(path):
            return (rng.standard_normal(a.shape)
                    / np.sqrt(a.shape[-2])).astype(np.float32)
        return a.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        leaf, jm.init(jax.random.PRNGKey(0)))
    m = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(
        np.float32), params)
    v = jax.tree.map(lambda a: ((0.5 + rng.random(a.shape)) * 1e-6).astype(
        np.float32), params)
    return {"params": params,
            "opt": {"m": m, "v": v, "step": np.int32(5)}}


def make_batch(cfg, seed=3, batch=B):
    """A ``SyntheticLM`` batch, with the vlm's prefix embeddings and the
    audio family's frames drawn from numpy."""
    src = data_lib.SyntheticLM(data_lib.DataConfig(
        vocab=cfg.vocab, seq_len=T, global_batch=batch, seed=seed))
    out = src.batch(0)
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def train_configs(microbatches=1):
    kw = dict(warmup_steps=2, total_steps=50, microbatches=microbatches)
    return (jtrain.TrainConfig(optimizer=jadamw.AdamWConfig(lr=LR), **kw),
            train_rt.TrainConfig(optimizer=adamw.AdamWConfig(lr=LR), **kw))


def no_function(name, kernel, plain, *inputs):
    """``ops._apply`` without the gradient's Function: the op calls its
    kernel directly (the control)."""
    return kernel(*inputs)


def run_both(family, dtype, microbatches=1):
    """One train step of the family's smoke model in both packages from
    the same state: the losses, gradients (the port's; JAX's as
    port-shaped float32 trees) and updated masters, and the step's
    metrics."""
    arch = FAMILIES[family]
    with compute_dtype(dtype):
        jm = jregistry.build(jconfigs.get_config(arch).smoke())
        tm = tregistry.build(tconfigs.get_config(arch).smoke(), device="cpu")
        state = reference_state(jm)
        batch = make_batch(tm.cfg, batch=B * microbatches)
        jt, tt = train_configs(microbatches)
        jstep = jtrain.make_train_step(jm, jt)

        def jfn(state, batch):
            loss, g = jax.value_and_grad(
                lambda p: jm.train_loss(p, batch, "nothing"))(state["params"])
            new, metrics = jstep(state, batch)
            return loss, g, new["params"], metrics

        jloss, jg, jnew, jmet = jax.jit(jfn)(
            jax.tree.map(jnp.asarray, state),
            jax.tree.map(jnp.asarray, batch))
        ts = convert.state_from_reference(state, tm.cfg, device="cpu")
        tloss, tg = train_rt.loss_and_grads(tm, ts["params"], batch)
        ts, tmet = train_rt.make_train_step(tm, tt)(ts, batch)

    def port_shaped(tree):
        return tL.tree_leaves(convert.masters_from_reference(
            jax.tree.map(np.asarray, tree), tm.cfg, device="cpu"))
    return dict(tloss=float(tloss), jloss=float(jloss), tg=tg,
                jg=port_shaped(jg), tnew=tL.tree_leaves(ts["params"]),
                jnew=port_shaped(jnew), tmet=tmet, jmet=jmet)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(family, dtype, microbatches=1):
        key = (family, dtype, microbatches)
        if key not in cache:
            cache[key] = run_both(family, dtype, microbatches)
        return cache[key]
    return get


def normwise(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


CASES = [(fam, dt) for fam in FAMILIES for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("family,dtype", CASES)
def test_train_step_loss_matches_the_reference(pairs, family, dtype):
    r = pairs(family, dtype)
    assert np.isfinite(r["tloss"])
    assert abs(r["tloss"] - r["jloss"]) <= TOL[dtype]["loss"] * abs(
        r["jloss"]), (r["tloss"], r["jloss"])
    # the step's own loss is the one it differentiated
    assert float(r["tmet"]["loss"]) == r["tloss"]


@pytest.mark.parametrize("family,dtype", CASES)
def test_train_step_gradients_match_the_reference(pairs, family, dtype):
    r = pairs(family, dtype)
    tol = TOL[dtype]["grads"]
    assert len(r["tg"]) == len(r["jg"])
    for i, (g, want) in enumerate(zip(r["tg"], r["jg"])):
        if g is None:                   # a leaf the loss does not read
            assert not want.any(), f"leaf {i}: JAX's gradient is not zero"
            continue
        assert g.dtype == torch.float32
        err = normwise(g, want)
        assert err <= tol, f"leaf {i} {tuple(g.shape)}: {err:.3g} > {tol}"
    gn = float(r["tmet"]["grad_norm"])
    assert abs(gn - float(r["jmet"]["grad_norm"])) <= tol * gn


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_updated_masters_match_the_reference(pairs, family):
    r = pairs(family, "float32")
    for i, (p, want) in enumerate(zip(r["tnew"], r["jnew"])):
        assert p.dtype == torch.float32
        err = normwise(p, want)
        assert err <= TOL["float32"]["masters"], \
            f"leaf {i} {tuple(p.shape)}: {err:.3g}"
    for k in ("lr", "clip", "grad_norm"):
        want = float(r["jmet"][k])
        assert abs(float(r["tmet"][k]) - want) <= 1e-6 * abs(want), k


def test_microbatched_train_step_matches_the_reference(pairs):
    """Two microbatches of 2 sequences, their gradients averaged in
    float32 (the reference's scan), the loss their mean."""
    r = pairs("dense", "float32", microbatches=2)
    assert abs(float(r["tmet"]["loss"]) - float(r["jmet"]["loss"])) <= \
        1e-5 * abs(float(r["jmet"]["loss"]))
    for p, want in zip(r["tnew"], r["jnew"]):
        assert normwise(p, want) <= TOL["float32"]["masters"]
    one = pairs("dense", "float32")
    assert float(r["tmet"]["grad_norm"]) != float(one["tmet"]["grad_norm"])


def test_a_leaf_read_twice_sums_its_cotangents_in_float32():
    """zamba2 with both groups on one shared block (4 layers, 1 shared
    block) in bf16: each read casts the float32 master again (the
    reference's ``cast`` at each use), so the block's gradient is the
    float32 sum of the two reads' cotangents, bit for bit the sum of the
    gradients of two copies of the block, one a group.  The control, the
    masters cast once (``cast_params``) and differentiated there, sums the
    two in bf16 and is not."""
    cfg = tconfigs.get_config("zamba2-7b").smoke()
    one = tregistry.build(dataclasses.replace(cfg, n_layers=4,
                                              n_shared_blocks=1), "cpu")
    two = tregistry.build(dataclasses.replace(cfg, n_layers=4,
                                              n_shared_blocks=2), "cpu")
    p1 = one.init_masters(0)
    p2 = dict(p1, shared=[p1["shared"][0],
                          tL.tree_map(torch.clone, p1["shared"][0])])
    batch = make_batch(cfg)
    with compute_dtype("bfloat16"):
        l1, g1 = train_rt.loss_and_grads(one, p1, batch)
        l2, g2 = train_rt.loss_and_grads(two, p2, batch)
        cast = tL.tree_map(lambda t: t.detach().requires_grad_(True),
                           tL.cast_params(p1, one.impl.FLOAT32_LEAVES))
        loss = one.train_loss(cast, data_lib.shard_batch(batch, "cpu"))
        shared_cast = tL.tree_leaves(cast["shared"][0])
        g_once = torch.autograd.grad(loss, shared_cast)
    assert torch.equal(l1, l2)

    def shared(params, grads, i):
        ids = [id(t) for t in tL.tree_leaves(params)]
        return [grads[ids.index(id(t))]
                for t in tL.tree_leaves(params["shared"][i])]
    reused = shared(p1, g1, 0)
    summed = [a + b for a, b in zip(shared(p2, g2, 0), shared(p2, g2, 1))]
    for a, b in zip(reused, summed):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not all(torch.equal(a.float(), b)
                   for a, b in zip(g_once, summed)), \
        "the control sums in float32 too: the test cannot tell"


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_policies_give_the_same_loss_and_gradients(family):
    model = tregistry.build_smoke(FAMILIES[family], device="cpu")
    params = model.init_masters(0)
    batch = make_batch(model.cfg)
    base = train_rt.loss_and_grads(model, params, batch, "none")
    for policy in ("nothing", "dots"):
        loss, grads = train_rt.loss_and_grads(model, params, batch, policy)
        assert torch.equal(loss, base[0]), policy
        for g, want in zip(grads, base[1]):
            assert (g is None and want is None) or torch.equal(g, want), \
                policy


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """Under ``"nothing"`` every layer's ops run again in the backward
    (K16 twice a layer, K15 once; the final norm is outside the layers),
    under ``"none"`` they do not; without a graph remat calls the layer
    as it is."""
    model = tregistry.build_smoke(FAMILIES["dense"], device="cpu")
    params = model.init_masters(0)
    batch = make_batch(model.cfg)
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for mod, name in ((trmsnorm, "rmsnorm"), (tattention, "flash_attention")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    L = model.cfg.n_layers
    for policy, fwd, again in (("none", 0, 0), ("nothing", 1, 1)):
        calls.update(rmsnorm=0, flash_attention=0)
        train_rt.loss_and_grads(model, params, batch, policy)
        assert calls == {"rmsnorm": (2 * L + 1) + again * 2 * L,
                         "flash_attention": L + again * L}, (policy, calls)
    calls.update(rmsnorm=0, flash_attention=0)
    with torch.no_grad():
        model.train_loss(params, data_lib.shard_batch(batch, "cpu"))
    assert calls == {"rmsnorm": 2 * L + 1, "flash_attention": L}


# ---------------------------------------------------------------------------
# the Function: the kernels' forward, the plain versions' VJP
# ---------------------------------------------------------------------------
def _detached(fn):
    """``fn`` (a kernel wrapper, whose CPU route is its plain version)
    under ``torch.no_grad()``: a stand-in for a kernel, whose output
    carries no graph."""
    def stand_in(*a, **k):
        with torch.no_grad():
            return fn(*a, **k)
    return stand_in


KERNELS = ((trmsnorm, "rmsnorm"), (tattention, "flash_attention"),
           (trwkv6, "wkv6"), (tmamba2, "ssd"))


@pytest.fixture
def stand_ins(monkeypatch):
    for mod, name in KERNELS:
        monkeypatch.setattr(mod, name, _detached(getattr(mod, name)))


def op_cases():
    g = torch.Generator().manual_seed(7)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def decay(*shape):
        return torch.exp(-torch.exp(rn(*shape, scale=0.5)))
    return {
        "rmsnorm": (lambda x, w: tops.rmsnorm(x, w, 1e-6),
                    lambda x, w: tref.rmsnorm(x, w, 1e-6),
                    [rn(2, 5, 64), 1 + 0.2 * rn(64)]),
        "flash_attention": (
            lambda q, k, v: tops.flash_attention(q, k, v, causal=True,
                                                 q_offset=3),
            lambda q, k, v: tref.flash_attention(
                q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1),
                causal=True, q_offset=3),
            [rn(2, 4, 13, 32), rn(2, 2, 16, 32), rn(2, 2, 16, 32)]),
        "rwkv6_scan": (tops.rwkv6_scan, tref.rwkv6_scan,
                       [rn(2, 9, 3, 8), rn(2, 9, 3, 8), rn(2, 9, 3, 16),
                        decay(2, 9, 3, 8), rn(3, 8)]),
        "mamba2_ssd": (tops.mamba2_ssd, tref.mamba2_ssd,
                       [rn(2, 9, 3, 8), -torch.exp(rn(2, 9, 3)),
                        rn(2, 9, 4), rn(2, 9, 4)]),
    }


def _op_grads(fn, inputs, seed=8):
    """Gradients of ``((fn(1.5 · x...) + bias) · c).sum()`` with respect
    to the leaves x (upstream of the op, through a product) and bias
    (downstream), or None where the graph does not reach a leaf."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*(1.5 * t for t in leaves))
    bias = torch.zeros((), requires_grad=True)
    c = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    loss = ((out + bias) * c).sum()
    return out.detach(), torch.autograd.grad(loss, leaves + [bias],
                                             allow_unused=True)


@pytest.mark.parametrize("op", ["rmsnorm", "flash_attention", "rwkv6_scan",
                                "mamba2_ssd"])
def test_function_gives_the_plain_gradients_behind_a_detached_kernel(
        op, stand_ins, monkeypatch):
    fn, plain, inputs = op_cases()[op]
    out, got = _op_grads(fn, inputs)
    want_out, want = _op_grads(plain, inputs)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)
    # the control: the same stand-in without the Function
    monkeypatch.setattr(tops, "_apply", no_function)
    _, ctl = _op_grads(fn, inputs)
    assert all(g is None for g in ctl[:-1]), "the control reached upstream"
    assert ctl[-1] is not None


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "audio"])
def test_function_behind_detached_kernels_gives_a_models_plain_gradients(
        family, monkeypatch):
    """A smoke model's gradients with all four kernels detached behind the
    Function equal plain autograd through the wrappers' CPU route, bit
    for bit (K17's CPU route runs the plain version on other axes than
    the Function's VJP, so its last bits differ: the op test above holds
    it); the control (no Function) leaves every parameter upstream of a
    kernel without a gradient: all but the head's."""
    model = tregistry.build_smoke(FAMILIES[family], device="cpu")
    params = model.init_masters(0)
    batch = make_batch(model.cfg)
    with monkeypatch.context() as m:
        m.setattr(tops, "_apply", no_function)
        plain = train_rt.loss_and_grads(model, params, batch)
    with monkeypatch.context() as m:
        for mod, name in KERNELS:
            m.setattr(mod, name, _detached(getattr(mod, name)))
        got = train_rt.loss_and_grads(model, params, batch)
        m.setattr(tops, "_apply", no_function)
        ctl = train_rt.loss_and_grads(model, params, batch)
    assert torch.equal(got[0], plain[0]) and torch.equal(ctl[0], plain[0])
    for g, w in zip(got[1], plain[1]):
        assert (g is None and w is None) or torch.equal(g, w)
    # the control: the loss still has a graph (the head is downstream of
    # every kernel; the MoE routers reach the load-balance loss), but the
    # final norm's detached output cuts the residual stream off
    ids = [id(t) for t in tL.tree_leaves(params)]
    head, embed = ids.index(id(params["lm_head"])), ids.index(
        id(params["embed"]))
    assert torch.equal(ctl[1][head], plain[1][head])
    assert ctl[1][embed] is None and plain[1][embed] is not None
    assert sum(g is not None for g in ctl[1]) < sum(
        g is not None for g in plain[1])


def test_ops_without_a_graph_call_the_kernel_directly(stand_ins):
    """No input requires a gradient, or grad mode is off: the op's output
    is the kernel's own (no Function node)."""
    x, w = torch.randn(3, 64), torch.ones(64)
    assert tops.rmsnorm(x, w).grad_fn is None
    with torch.no_grad():
        assert tops.rmsnorm(x.requires_grad_(True), w).grad_fn is None
    node = tops.rmsnorm(x, w).grad_fn           # the reshape, then the op
    assert type(node.next_functions[0][0]).__name__ == "_RefVJPBackward"


def test_sigmoid_and_softplus_take_the_references_gradients():
    """``logistic``'s JVP g·s·(1−s) (finite where exp(-x) overflows) and
    ``logaddexp``'s g·exp(x − softplus(x)) (1/2 at x = 0), against
    ``jax.grad``; the forward values as before."""
    x = np.array([-200.0, -30.0, -1.0, 0.0, 0.5, 3.0, 40.0, 120.0],
                 np.float32)
    for port, ref in ((tL.sigmoid, jax.nn.sigmoid),
                      (tL.softplus, jax.nn.softplus)):
        t = torch.from_numpy(x).requires_grad_(True)
        y = port(t)
        (g,) = torch.autograd.grad(y.sum(), [t])
        want = jax.grad(lambda a: ref(a).sum())(jnp.asarray(x))
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-30)
        with torch.no_grad():
            assert torch.equal(y.detach(), port(torch.from_numpy(x)))


# ---------------------------------------------------------------------------
# AdamW, schedule, data
# ---------------------------------------------------------------------------
def test_adamw_update_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}

    def draw(scale, positive=False):
        def leaf(s):
            a = rng.standard_normal(s) * scale
            return np.abs(a).astype(np.float32) if positive else a.astype(
                np.float32)
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(
            s, tuple))
    p, g, m, v = draw(1.0), draw(3.0), draw(1e-2), draw(1e-3, True)
    cfg_j = jadamw.AdamWConfig(lr=1e-2)
    cfg_t = adamw.AdamWConfig(lr=1e-2)
    for step in (0, 4, 99):
        lr_j = jschedule.warmup_cosine(step, 10, 100)
        lr_t = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                      10, 100)
        assert abs(float(lr_t) - float(lr_j)) <= 1e-6
        jp, jst, jmet = jadamw.update(
            g, {"m": m, "v": v, "step": jnp.int32(step)}, p, cfg_j, lr_j)

        def t(tree):
            return tL.tree_map(lambda a: torch.from_numpy(np.array(a)),
                               tree)
        tp, tst, tmet = adamw.update(
            t(g), {"m": t(m), "v": t(v), "step": torch.tensor(
                step, dtype=torch.int32)}, t(p), cfg_t, lr_t)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for k in ("grad_norm", "lr", "clip"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-6 * max(
                1.0, abs(float(jmet[k]))), k
        for got, want in ((tp, jp), (tst["m"], jst["m"]),
                          (tst["v"], jst["v"])):
            for a, b in zip(tL.tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 150])
def test_schedules_match_the_reference(step):
    assert abs(float(schedule.warmup_cosine(step, 10, 100)) - float(
        jschedule.warmup_cosine(step, 10, 100))) <= 1e-6
    assert float(schedule.linear_warmup(step, 10)) == float(
        jschedule.linear_warmup(step, 10))


def test_synthetic_batches_equal_the_references():
    for kw in (dict(vocab=100, seq_len=8, global_batch=4, seed=3),
               dict(vocab=151936, seq_len=33, global_batch=3, seed=0)):
        t = data_lib.make_source(data_lib.DataConfig(**kw))
        j = jdata.make_source(jdata.DataConfig(**kw))
        for step in (0, 17):
            for sl in (slice(None), slice(1, 3)):
                a, b = t.batch(step, sl), j.batch(step, sl)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_corpus_batches_equal_the_references(tmp_path):
    path = str(tmp_path / "corpus.npy")
    np.save(path, np.random.default_rng(4).integers(
        0, 1000, 5000).astype(np.uint16))
    kw = dict(vocab=1000, seq_len=16, global_batch=4, seed=9,
              corpus_path=path)
    t = data_lib.make_source(data_lib.DataConfig(**kw))
    j = jdata.make_source(jdata.DataConfig(**kw))
    assert isinstance(t, data_lib.CorpusLM)
    for step in (0, 3, 1000):
        a, b = t.batch(step, slice(1, 4)), j.batch(step, slice(1, 4))
        for k in a:
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_data_pipeline_restart_exact_and_prefetch():
    dcfg = data_lib.DataConfig(vocab=100, seq_len=8, global_batch=4, seed=3)
    src = data_lib.make_source(dcfg)
    b1 = src.batch(17)
    b2 = data_lib.make_source(dcfg).batch(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    hs = src.batch(17, host_slice=slice(2, 4))
    np.testing.assert_array_equal(hs["tokens"], b1["tokens"][2:4])
    it = data_lib.prefetch(src, 15)
    for want in (15, 16, 17):
        step, b = next(it)
        assert step == want
    it.close()
    np.testing.assert_array_equal(b["labels"], b1["labels"])
    moved = data_lib.shard_batch(b, "cpu")
    assert moved["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(moved["tokens"].numpy(), b1["tokens"])


# ---------------------------------------------------------------------------
# checkpoints and the loop (the reference's test_fault_tolerance.py)
# ---------------------------------------------------------------------------
def _setup(steps=12, ckpt_every=4):
    model = tregistry.build_smoke("qwen2-1.5b", device="cpu")
    dcfg = data_lib.DataConfig(vocab=model.cfg.vocab, seq_len=16,
                               global_batch=2, seed=7)
    source = data_lib.make_source(dcfg)
    tcfg = train_rt.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3),
                                warmup_steps=2, total_steps=steps,
                                ckpt_every=ckpt_every, max_restarts=5)
    step_fn = train_rt.make_train_step(model, tcfg)

    def init_fn():
        return train_rt.init_state(model, 0)
    return model, source, step_fn, tcfg, init_fn


def _tree_equal(a, b):
    la, lb = tL.tree_leaves(a), tL.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.tensor([1.5, -2.25, 3e-3, 7e8],
                                       dtype=torch.bfloat16),
                     "step": torch.tensor(7, dtype=torch.int32)},
            "layers": [{"w": torch.randn(2)}, {"w": torch.randn(2)}]}
    ckpt.save(str(tmp_path), 3, tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    template = tL.tree_map(lambda t: torch.empty_like(t, device="meta"),
                           tree)
    got, step = ckpt.restore(str(tmp_path), template, device="cpu")
    assert step == 3
    assert _tree_equal(got, tree)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        man = json.load(f)
    paths = [e["path"] for e in man["leaves"]]
    assert paths == ["['a']", "['layers'][0]['w']", "['layers'][1]['w']",
                     "['nest']['b']", "['nest']['step']"]
    assert [e["dtype"] for e in man["leaves"]][3:] == ["bfloat16", "int32"]
    with pytest.raises(ValueError, match="meta"):
        ckpt.restore(str(tmp_path), template)


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 0, {"x": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"x": torch.empty(3, 2, device="meta")},
                     device="cpu")


def test_async_checkpointer_equivalent(tmp_path):
    tree = {"w": torch.arange(10.0)}
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(5, tree)
    tree["w"].add_(1)               # the snapshot was taken at save()
    saver.wait()
    got, step = ckpt.restore(str(tmp_path), {"w": torch.empty(10)})
    assert step == 5
    assert torch.equal(got["w"], torch.arange(10.0))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port restores a dict tree that the JAX ``ckpt.save`` wrote
    (bfloat16 through its uint16 codec), and the reference restores the
    port's."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nest": {"b": np.array([1.5, -2.25, 3e-3], np.float32),
                     "step": np.int32(7)}}
    jtree = {"a": jnp.asarray(tree["a"]),
             "nest": {"b": jnp.asarray(tree["nest"]["b"], jnp.bfloat16),
                      "step": jnp.asarray(tree["nest"]["step"])}}
    jckpt.save(str(tmp_path / "jax"), 2, jtree)
    template = {"a": torch.empty(2, 3, device="meta"),
                "nest": {"b": torch.empty(3, dtype=torch.bfloat16,
                                          device="meta"),
                         "step": torch.empty((), dtype=torch.int32,
                                             device="meta")}}
    got, step = ckpt.restore(str(tmp_path / "jax"), template, device="cpu")
    assert step == 2
    assert got["nest"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nest"]["b"], torch.tensor(
        tree["nest"]["b"]).to(torch.bfloat16))
    assert torch.equal(got["a"], torch.from_numpy(tree["a"]))
    assert int(got["nest"]["step"]) == 7
    ckpt.save(str(tmp_path / "port"), 4, got)
    back, _ = jckpt.restore(str(tmp_path / "port"),
                            jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_training_resumes_exactly_after_failure(tmp_path):
    """Kill training mid-run; the restarted run's losses and final state
    equal an uninterrupted run's bit for bit."""
    steps = 12
    model, source, step_fn, tcfg, init_fn = _setup(steps)
    ref_loop = train_rt.TrainLoop(model, source, step_fn, tcfg,
                                  str(tmp_path / "ref"), init_fn)
    ref_state = ref_loop.run(steps)
    ref = [h["loss"] for h in ref_loop.history]
    fired = {"done": False}

    def injector(step):
        if step == 6 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected node failure")

    model, source, step_fn, tcfg, init_fn = _setup(steps)
    loop = train_rt.TrainLoop(model, source, step_fn, tcfg,
                              str(tmp_path / "ft"), init_fn,
                              failure_injector=injector)
    state = loop.run(steps)
    assert loop.restarts == 1
    got = {h["step"]: h["loss"] for h in loop.history}
    for i, loss in enumerate(ref):
        assert got[i] == loss, f"step {i} diverged"
    assert _tree_equal(state, ref_state)
    assert int(state["opt"]["step"]) == steps


def test_too_many_failures_raises(tmp_path):
    model, source, step_fn, tcfg, init_fn = _setup(steps=8)

    def injector(step):
        raise RuntimeError("permanently broken")

    loop = train_rt.TrainLoop(model, source, step_fn, tcfg, str(tmp_path),
                              init_fn, failure_injector=injector)
    with pytest.raises(RuntimeError, match="permanently broken"):
        loop.run(8)
    assert loop.restarts == tcfg.max_restarts + 1


def test_straggler_watchdog(tmp_path):
    model, source, step_fn, tcfg, init_fn = _setup(steps=12)
    loop = train_rt.TrainLoop(model, source, step_fn, tcfg, str(tmp_path),
                              init_fn)
    times = iter([0.1] * 10 + [5.0] + [0.1] * 10)   # one slow step
    orig_watch = loop._watch

    def patched_watch(step, dt):
        orig_watch(step, next(times, 0.1))

    loop._watch = patched_watch
    loop.run(12)
    assert loop.stragglers == [10]


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU, then again from
    its checkpoint; asked for a mesh it raises."""
    from repro_torch.launch import train as launch
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--device", "cpu"]
    loop = launch.main(args)
    assert [h["step"] for h in loop.history] == [0, 1, 2, 3]
    assert ckpt.latest_step(str(tmp_path)) == 3
    again = launch.main(args[:4] + ["6"] + args[5:])
    assert [h["step"] for h in again.history] == [4, 5]
    assert "arch=qwen2-1.5b" in capsys.readouterr().out
    for extra in (["--devices", "2"], ["--model-parallel", "2"]):
        with pytest.raises(NotImplementedError, match="sharding/rules.py"):
            launch.main(args + extra)


def test_launcher_without_a_checkpoint_dir_starts_afresh(tmp_path,
                                                         monkeypatch):
    """Without ``--ckpt-dir`` each run checkpoints into a new temporary
    directory, so a second run trains from step 0 as the first did (a
    fixed default would resume the first run's checkpoint)."""
    import tempfile

    from repro_torch.launch import train as launch
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    runs = [launch.main(args) for _ in range(2)]
    for loop in runs:
        assert [h["step"] for h in loop.history] == [0, 1]
    dirs = {loop.ckpt_dir for loop in runs}
    assert len(dirs) == 2 and all(
        os.path.dirname(d) == str(tmp_path) for d in dirs)
    assert [h["loss"] for h in runs[0].history] == \
        [h["loss"] for h in runs[1].history]


def test_init_state_and_masters():
    """float32 masters are ``init``'s draws unrounded, each leaf its own
    storage; the meta template has their shapes; ``cast_params`` maps
    them to the serving tree."""
    model = tregistry.build_smoke("zamba2-7b", device="cpu")
    st = train_rt.init_state(model, 3)
    masters = st["params"]
    leaves = tL.tree_leaves(masters)
    assert all(t.dtype == torch.float32 for t in leaves)
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == len(
        leaves)
    served = model.init(3)
    cast = tL.cast_params(masters, model.impl.FLOAT32_LEAVES)
    assert _tree_equal(cast, served)
    meta = train_rt.init_state(model, device="meta")
    assert [tuple(t.shape) for t in tL.tree_leaves(meta)] == [
        tuple(t.shape) for t in tL.tree_leaves(st)]
    assert int(st["opt"]["step"]) == 0
    assert st["opt"]["step"].dtype == torch.int32
