"""Model building blocks: parameter templates, norms, RoPE, attention, MLP.

Port of the reference's ``models/layers.py``.  Parameters are plain nested
dicts of tensors, the reference's tree.  Each model defines a *template*
tree of :class:`Spec` descriptors (shapes, logical axes, initializers),
from which :func:`init_params` materializes random parameters.

Departures from the reference, each with its reason:

* The reference keeps float32 parameters and casts them to
  ``COMPUTE_DTYPE`` at every use.  The port keeps each parameter as that
  cast, done once at load (:func:`init_params`,
  :func:`repro_torch.models.convert.params_from_reference`): the same
  numbers, without re-reading the float32 weights on every step.  The
  ``cast`` calls stay, and are no-ops on such parameters.  The leaves the
  reference reads without ``cast`` (each family module's
  ``FLOAT32_LEAVES``) stay float32, and the arithmetic around them
  promotes as the reference's does.  Training keeps the reference's
  float32 masters (``init_params(..., masters=True)``) and hands them to
  ``train_loss`` as they are, so there every ``cast`` casts at its use,
  as in the reference; :func:`cast_params` maps masters to the serving
  tree.
* ``sharding.rules.constraint`` has no counterpart on one card and is
  dropped; a :class:`Spec` keeps its logical axes as data.
* Random draws come from an explicit ``torch.Generator`` on the target
  device, so they are not JAX's draws: only ``params_from_reference``
  makes the two packages compute the same function.  The distribution is
  the reference's, including its fan-in: for a stacked layer tensor
  (``stack_layers``) that is the leading layer count.
* ``FLAGS.decode_gqa_packed``'s decode attention contracts each KV
  head with its G query heads, without the GQA repeat, as the reference
  does.  The reference's einsums take bfloat16 operands and accumulate
  in float32 (``preferred_element_type``).  On the card the scores are
  ``torch.bmm(..., out_dtype=torch.float32)`` on the bfloat16 keys and
  P·V a float32 product on the values cast once (float32 weights, as the
  reference keeps them); on the CPU both are float32 products of the cast
  operands ordered as the unpacked path orders them, so that the two
  paths agree bit for bit there, as the reference's test asks of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..kernels import ops
from ..runtime import flags

COMPUTE_DTYPE = torch.bfloat16

#: the reference's decode-attention mask value (its kernel's, too)
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Spec:
    """Descriptor for one parameter tensor."""
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]      # logical sharding axes
    init: str = "normal"                 # normal | zeros | ones
    scale: Optional[float] = None        # fan-in scaling override

    def materialize(self, gen: torch.Generator,
                    dtype: torch.dtype) -> torch.Tensor:
        """The tensor on ``gen``'s device, in ``dtype``: zeros, ones, or a
        float32 normal draw times ``scale`` (default 1/sqrt(fan-in)),
        rounded once to ``dtype``."""
        dev = gen.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=dev)
        scale = self.scale
        if scale is None:
            fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        t = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dtype)


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists, in their
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in :func:`tree_map`'s
    order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def leaf_dtype(name: str, float32_leaves=frozenset()) -> torch.dtype:
    """The dtype the port holds the leaf called ``name`` in: float32 if
    it is one of the family's ``float32_leaves`` (read by the reference
    without ``cast``), else ``COMPUTE_DTYPE``."""
    return torch.float32 if name in float32_leaves else COMPUTE_DTYPE


def tree_map_named(fn, tree, name: str = ""):
    """``fn(leaf, name)`` over the leaves of a tree of dicts and lists,
    ``name`` the dict key the leaf (or the list it is in) sits under, in
    the tree's order."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_named(fn, v, name) for v in tree]
    return fn(tree, name)


def cast_params(masters, float32_leaves=frozenset()):
    """The float32 master tree in the dtypes of :func:`leaf_dtype` (read
    at call time): the serving tree that ``init`` and
    ``convert.params_from_reference`` give.  Differentiable (``Tensor.to``),
    but training does not go through it: ``train_loss`` takes the masters
    and each ``cast`` casts at its use, as the reference does, so that the
    two cotangents of a leaf read twice (zamba2's shared blocks, a tied
    embedding) sum in float32 on the master, not in the compute dtype."""
    return tree_map_named(
        lambda t, name: t.to(leaf_dtype(name, float32_leaves)), masters)


def init_params(gen: torch.Generator, template,
                float32_leaves=frozenset(), masters: bool = False) -> Any:
    """Materialize every Spec of ``template`` on ``gen``'s device, in
    ``COMPUTE_DTYPE`` (``float32_leaves`` in float32), in the template's
    order; with ``masters``, every leaf in float32 (the same draws,
    unrounded: the reference's ``init``)."""
    return tree_map_named(
        lambda s, name: s.materialize(
            gen, torch.float32 if masters
            else leaf_dtype(name, float32_leaves)),
        template)


def param_count(template) -> int:
    shapes: list = []
    tree_map(lambda s: shapes.append(s.shape), template)
    return sum(math.prod(sh) for sh in shapes)


def stack_layers(layer_template, n: int) -> Any:
    """Prepend a 'layers' axis of ``n`` to every Spec in a layer template."""
    return tree_map(
        lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        layer_template)


def unstack(tree, depth: int = 1) -> list:
    """A stacked subtree (every leaf with the same leading axes) as a list
    of per-index subtrees of views, nested ``depth`` axes deep."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    items = [tree_map(lambda t, i=i: t[i], tree) for i in range(leaf.shape[0])]
    return items if depth == 1 else [unstack(t, depth - 1) for t in items]


def unstack_params(params: dict, stacked: dict) -> dict:
    """The parameter tree with each subtree of ``stacked`` (the family's
    ``STACKED``: template key → number of leading stacked axes) split into
    (nested) lists of views, walked by the models' Python loops."""
    out = dict(params)
    for key, depth in stacked.items():
        if key in params:
            out[key] = unstack(params[key], depth)
    return out


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps):
    return ops.rmsnorm(x, cast(scale), eps)


def linear(x, w, b=None):
    y = x @ cast(w)
    if b is not None:
        y = y + cast(b)
    return y


def rope(x, positions, theta: float):
    """Rotary embedding in float32. x: (..., T, H, D); positions: (T,) or
    (..., T)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., T, half)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., T, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def _softplus(x):
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


class _Sigmoid(torch.autograd.Function):
    """:func:`sigmoid` with ``logistic``'s JVP, ``g · (s · (1 − s))``:
    the expansion's own gradient is NaN where ``exp(-x)`` overflows."""

    @staticmethod
    def forward(ctx, x):
        s = _sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


class _Softplus(torch.autograd.Function):
    """:func:`softplus` with ``logaddexp``'s JVP, ``g · exp(x − out)``
    (the expansion's gradient is 1 at x = 0, not 1/2)."""

    @staticmethod
    def forward(ctx, x):
        out = _softplus(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def sigmoid(x):
    """``1 / (1 + exp(-x))``, every op rounded to x's dtype: XLA expands
    ``jax.nn.sigmoid`` (``logistic``) into those ops, each rounded in
    bfloat16 (``torch.sigmoid`` rounds once, and differs in 3 % of the
    bfloat16 values).  Its gradient is ``logistic``'s (:class:`_Sigmoid`,
    only where a graph is built: the serving paths skip the Function's
    host cost)."""
    return _Sigmoid.apply(x) if ops.needs_graph(x) else _sigmoid(x)


def silu(x):
    """``x * sigmoid(x)`` with :func:`sigmoid`'s rounding, as
    ``jax.nn.silu`` (``x * logistic(x)``)."""
    return x * sigmoid(x)


def softplus(x):
    """``max(x, 0) + log1p(exp(-|x|))``, ``jax.nn.softplus``'s formula
    (``logaddexp(x, 0)``; ``F.softplus`` cuts over to x above 20), with
    ``logaddexp``'s gradient (:class:`_Softplus`)."""
    return _Softplus.apply(x) if ops.needs_graph(x) else _softplus(x)


def swiglu(x, w_gate, w_up, w_down):
    h = silu(linear(x, w_gate)) * linear(x, w_up)
    return linear(h, w_down)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form, op by op as XLA expands
    it, every op rounded to x's dtype: ``x * (0.5 * (1 + tanh(c1 * (x +
    c0 * x³))))`` with x³ = ``x * (x * x)`` (``integer_pow``) and the
    constants rounded to x's dtype first (in bfloat16 c0 = 0.044677734375,
    c1 = 0.796875).  ``F.gelu(approximate="tanh")`` rounds once, a
    different function in bfloat16."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    x3 = x * (x * x)
    t = torch.tanh(c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * x3))
    return x * (c(0.5) * (t + c(1.0)))


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    return linear(gelu(linear(x, w_up, b_up)), w_down, b_down)


# ---------------------------------------------------------------------------
# attention (GQA, RoPE, optional KV cache)
# ---------------------------------------------------------------------------
def attn_template(cfg) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "wq": Spec((D, H * Dh), ("embed_fsdp", "heads")),
        "wk": Spec((D, Hkv * Dh), ("embed_fsdp", "kv_heads")),
        "wv": Spec((D, Hkv * Dh), ("embed_fsdp", "kv_heads")),
        "wo": Spec((H * Dh, D), ("heads", "embed_fsdp")),
    }
    if cfg.qkv_bias:
        t["bq"] = Spec((H * Dh,), ("heads",), init="zeros")
        t["bk"] = Spec((Hkv * Dh,), ("kv_heads",), init="zeros")
        t["bv"] = Spec((Hkv * Dh,), ("kv_heads",), init="zeros")
    return t


def attn_qkv(p, cfg, x, positions, *, use_rope=True):
    """x: (B, T, D) → q (B, H, T, Dh), k/v (B, Hkv, T, Dh), RoPE on q, k
    unless ``use_rope`` is False."""
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, T, H, Dh)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, T, Hkv, Dh)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, T, Hkv, Dh)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attn_out(p, x_attn):
    """x_attn: (B, H, T, Dh) → (B, T, D)."""
    B, H, T, Dh = x_attn.shape
    y = x_attn.transpose(1, 2).reshape(B, T, H * Dh)
    return linear(y, p["wo"])


def _write_lanes(cache, new, pos):
    """``cache[b, :, pos[b]] = new[b]`` for every lane, in place.  The
    reference's ``.at[b, h, pos].set`` counts a negative index from the
    end and drops one outside the cache; torch indexing would raise, so
    such a lane rewrites its old row instead."""
    Tmax = cache.shape[2]
    idx = torch.where(pos < 0, pos + Tmax, pos)
    keep = (idx >= 0) & (idx < Tmax)
    idx = idx.clamp(0, Tmax - 1).long()
    b = torch.arange(cache.shape[0], device=cache.device)
    old = cache[b, :, idx]                                # (B, Hkv, Dh)
    cache[b, :, idx] = torch.where(keep[:, None, None], new.to(cache.dtype),
                                   old)


def self_attention(p, cfg, x, positions, *, causal=True, use_rope=True):
    """Attention of x over itself on K15: (B, T, D) → (B, T, D)."""
    q, k, v = attn_qkv(p, cfg, x, positions, use_rope=use_rope)
    return attn_out(p, ops.flash_attention(q, k, v, causal=causal))


def grouped_scores(qg, k):
    """Scores of G query heads against their KV head's cache, accumulated
    and returned in float32, as the reference's einsum with
    ``preferred_element_type=float32``.  qg: (N, G, Dh); k: (N, Tmax, Dh)
    → (N, G, Tmax).

    On the card one product, M = G rows a KV head; bfloat16 operands go to
    ``torch.bmm``'s ``out_dtype`` form (products exact in float32, summed
    in float32), with no float32 copy of the cache.  On the CPU one
    product a query head (M = 1, the cache cast to float32 once), the
    shape the unpacked path's einsum gives the BLAS, so that the packed
    and unpacked scores are equal bit for bit."""
    kt = k.transpose(1, 2)
    if qg.is_cuda:
        if qg.dtype == kt.dtype == torch.bfloat16:
            return torch.bmm(qg, kt, out_dtype=torch.float32)
        return torch.bmm(qg.float(), kt.float())
    kt = kt.float()
    qf = qg.float()
    return torch.stack([torch.bmm(qf[:, g:g + 1], kt)[:, 0]
                        for g in range(qg.shape[1])], dim=1)


def grouped_values(w, v):
    """The float32 weights' sums of the cache rows: w (N, G, Tmax) float32,
    v (N, Tmax, Dh) → (N, G, Dh) in float32, w kept in float32 as the
    reference keeps it.

    On the card one product, M = G rows a KV head, on the cache cast to
    float32 once (a copy of one KV head's rows, not of G repeats).  On
    the CPU one product a query head, as :func:`grouped_scores`."""
    vf = v.float()
    if w.is_cuda:
        return torch.bmm(w, vf)
    return torch.stack([torch.bmm(w[:, g:g + 1], vf)[:, 0]
                        for g in range(w.shape[1])], dim=1)


def decode_attention(p, cfg, x, cache_k, cache_v, pos, *, use_rope=True):
    """One-token decode. x: (B, 1, D); cache_k/v: (B, Hkv, Tmax, Dh),
    written in place; pos: an int (every lane at that position) OR a (B,)
    int tensor of per-lane positions (continuous batching: each serving
    slot may be at a different depth).  Returns (y, cache_k, cache_v).

    With ``FLAGS.decode_gqa_packed`` each KV head's cache is contracted
    with its G query heads (:func:`grouped_scores`,
    :func:`grouped_values`), with no GQA repeat and, on the card, the
    keys read in bfloat16 and the values cast to float32 once; else the
    cache is repeated G times and cast to float32, as the reference's
    baseline does."""
    B = x.shape[0]
    Hkv, Tmax = cfg.n_kv_heads, cache_k.shape[2]
    per_lane = torch.is_tensor(pos) and pos.dim() == 1
    if per_lane:
        pos = pos.to(device=x.device, dtype=torch.int32)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = attn_qkv(p, cfg, x, positions, use_rope=use_rope)
    if per_lane:
        _write_lanes(cache_k, k[:, :, 0], pos)
        _write_lanes(cache_v, v[:, :, 0], pos)
        row_pos = pos[:, None, None, None]
    else:
        # dynamic_update_slice clamps the start so that the row fits
        start = min(max(pos, 0), Tmax - 1)
        cache_k[:, :, start:start + 1] = k.to(cache_k.dtype)
        cache_v[:, :, start:start + 1] = v.to(cache_v.dtype)
        row_pos = pos
    Hq, Dh = cfg.n_heads, cfg.head_dim
    scale = Dh ** -0.5
    mask = torch.arange(Tmax, device=x.device)[None, None, None, :] <= row_pos
    if flags.FLAGS.decode_gqa_packed:
        G = Hq // Hkv
        qg = q.reshape(B * Hkv, G, Dh)
        s = grouped_scores(qg, cache_k.reshape(B * Hkv, Tmax, Dh))
        s = torch.where(mask, s.view(B, Hkv, G, Tmax) * scale, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = grouped_values(w.view(B * Hkv, G, Tmax),
                           cache_v.reshape(B * Hkv, Tmax, Dh))
        o = o.view(B, Hq, 1, Dh).to(x.dtype)
        return attn_out(p, o), cache_k, cache_v
    kk = cache_k.repeat_interleave(Hq // Hkv, dim=1)
    vv = cache_v.repeat_interleave(Hq // Hkv, dim=1)
    # masked single-query attention over the cache (memory-bound; plain
    # torch, as the reference's is plain jnp)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, vv.float()).to(x.dtype)
    return attn_out(p, o), cache_k, cache_v


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def softmax_xent(logits, labels, mask=None):
    """logits (..., V) fp32 CE; labels int; mask optional weights."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
