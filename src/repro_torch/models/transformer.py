"""Decoder-only transformer family: dense (yi / command-r / phi3 / qwen2),
MoE (olmoe / qwen2-moe) and prefix-LM VLM (paligemma).

Port of the reference's ``models/transformer.py``.  The reference stacks
the layers on a scanned axis; here ``params["layers"]`` is a list of
per-layer dicts (views of the stacked tensors the template draws), walked
by a Python loop.  The KV cache keeps the reference's layout, ``{"k",
"v"}`` of (L, B, Hkv, Tmax, Dh) (under ``FLAGS.decode_kv_int8`` int8,
with float32 scales ``k_s``, ``v_s`` of (L, B, Hkv, Tmax)), and is
written in place: ``decode_step`` and ``chunk_step`` return the cache
they were given.

The MoE layer (:func:`moe_apply`) keeps the reference's scatter dispatch
and its two forms, global and ``FLAGS.moe_grouped``; the expert products
are plain batched matrix products (``torch.bmm``/``einsum``), as the
reference leaves them to XLA.  The VLM's prefix-LM attention is two K15
calls a layer (:func:`prefix_attention`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils import checkpoint as _checkpoint

from ..kernels import ops
from ..runtime import flags
from . import layers as L
from .layers import Spec, cast


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------
def padded_experts(n: int, mult: int = 16) -> int:
    return -(-n // mult) * mult


def moe_template(cfg) -> dict:
    m = cfg.moe
    E = padded_experts(m.num_experts)
    D, F = cfg.d_model, m.d_expert
    t = {
        "router": Spec((D, E), (None, "expert")),
        "w_gate": Spec((E, D, F), ("expert", "embed_fsdp", None)),
        "w_up": Spec((E, D, F), ("expert", "embed_fsdp", None)),
        "w_down": Spec((E, F, D), ("expert", None, "embed_fsdp")),
    }
    if m.num_shared:
        t["shared"] = {
            "w_gate": Spec((D, m.d_shared), ("embed_fsdp", "mlp")),
            "w_up": Spec((D, m.d_shared), ("embed_fsdp", "mlp")),
            "w_down": Spec((m.d_shared, D), ("mlp", "embed_fsdp")),
            "gate_proj": Spec((D, 1), (None, None)),
        }
    return t


def mlp_template(cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": Spec((D, F), ("embed_fsdp", "mlp")),
        "w_up": Spec((D, F), ("embed_fsdp", "mlp")),
        "w_down": Spec((F, D), ("mlp", "embed_fsdp")),
    }


def block_template(cfg) -> dict:
    t = {
        "ln1": Spec((cfg.d_model,), (None,), init="ones"),
        "attn": L.attn_template(cfg),
        "ln2": Spec((cfg.d_model,), (None,), init="ones"),
    }
    t["moe" if cfg.moe else "mlp"] = (moe_template(cfg) if cfg.moe
                                      else mlp_template(cfg))
    return t


#: the leaves the reference reads without ``cast`` (none here), and the
#: stacked subtrees with their number of leading stacked axes
FLOAT32_LEAVES = frozenset()
STACKED = {"layers": 1}


def template(cfg) -> dict:
    t = {
        "embed": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"),
                      scale=1.0),
        "layers": L.stack_layers(block_template(cfg), cfg.n_layers),
        "final_norm": Spec((cfg.d_model,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = Spec((cfg.d_model, cfg.vocab), ("embed_fsdp", "vocab"))
    return t


# ---------------------------------------------------------------------------
# MoE forward (scatter-based dispatch)
# ---------------------------------------------------------------------------
def top_k(probs, k: int):
    """``jax.lax.top_k`` on the last axis: the k largest values and their
    indices, equal values in index order (the lower index first).
    ``torch.topk`` promises no order among ties, and ties are common here:
    bfloat16 router scores, and probabilities that underflow to exactly
    0 (unchosen experts still take capacity slots by their order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg, x):
    """Router probabilities in float32 (padded experts masked to -1e30
    before the softmax) and the renormalised top-k gates and indices, over
    x's leading axes."""
    m = cfg.moe
    E = padded_experts(m.num_experts)
    scores = (x @ cast(p["router"])).float()
    if E != m.num_experts:
        pad = torch.arange(E, device=x.device) >= m.num_experts
        scores = torch.where(pad, L.NEG_INF, scores)
    probs = torch.softmax(scores, dim=-1)
    gates, topi = top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, topi


def _slots(flat_e, E: int, C: int):
    """Each assignment's row in the (E·C + 1)-row dispatch buffer: its
    expert's block, at its rank among the assignments to that expert in
    ``flat_e``'s order along the last axis (a one-hot cumsum); an
    assignment past the capacity C goes to the drop row E·C.  Returns
    (dst, keep).  The one-hot is built by a comparison and laid out (...,
    E, n), the assignments on the last axis: ``F.one_hot`` reads its
    input's range back to the host, and a cumsum along the outer axis of
    (n, E) runs one thread a column on the card."""
    experts = torch.arange(E, device=flat_e.device)[:, None]
    onehot = (flat_e[..., None, :] == experts).to(torch.int32)   # (.., E, n)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1
    my_pos = torch.gather(pos, -2, flat_e[..., None, :])[..., 0, :]
    keep = my_pos < C
    dst = torch.where(keep, flat_e * C + my_pos, E * C)
    return dst, keep


def moe_apply(p, cfg, x, *, need_aux: bool = True):
    """x: (B, T, D) → (y, aux), aux a float32 scalar tensor (0.0 with
    ``need_aux=False``: the callers that drop it skip its dozen launches,
    as XLA drops the reference's unused aux).

    Baseline: one global scatter dispatch (position cumsum over all B·T·k
    assignment rows).  With ``FLAGS.moe_grouped``: GShard-style grouped
    dispatch — per-sequence capacity and position cumsum.  The dispatch
    buffer's rows are written by ``index_copy_``: kept assignments have
    rows of their own, so the copy is the reference's scatter-add onto
    zeros; the drop row (many writers) is discarded, as in the reference.
    """
    m = cfg.moe
    E = padded_experts(m.num_experts)
    k = m.top_k
    B, T, D = x.shape
    N = B * T
    # the global dispatch is the grouped one over a single group of all
    # N tokens
    G, n = (B, T) if flags.FLAGS.moe_grouped else (1, N)
    xg = x.reshape(G, n, D)
    probs, gates, topi = _route(p, cfg, xg)                      # (G, n, k)
    C = max(int(math.ceil(n * k / E * m.capacity_factor)), 1)
    dst, keep = _slots(topi.reshape(G, n * k), E, C)             # (G, n·k)
    rows = E * C + 1
    x_rep = xg.repeat_interleave(k, dim=1)                       # (G, n·k, D)
    base = torch.arange(G, device=x.device)[:, None] * rows
    xe = x.new_zeros(G * rows, D).index_copy_(
        0, (dst + base).reshape(-1), x_rep.reshape(-1, D))
    xe = xe.view(G, rows, D)[:, :-1].reshape(G, E, C, D)
    h = L.silu(torch.einsum("gecd,edf->gecf", xe, cast(p["w_gate"]))) \
        * torch.einsum("gecd,edf->gecf", xe, cast(p["w_up"]))
    ye = torch.einsum("gecf,efd->gecd", h, cast(p["w_down"]))
    ye_flat = torch.cat([ye.reshape(G, E * C, D), x.new_zeros(G, 1, D)],
                        dim=1)
    y_tok = torch.gather(ye_flat, 1, dst[..., None].expand(-1, -1, D)) \
        * keep[..., None].to(x.dtype)
    y = (y_tok.reshape(G, n, k, D)
         * gates[..., None].to(x.dtype)).sum(dim=2).reshape(B, T, D)

    if m.num_shared:
        s = p["shared"]
        shared_out = L.swiglu(x, s["w_gate"], s["w_up"], s["w_down"])
        g = L.sigmoid(L.linear(x, s["gate_proj"]))
        y = y + g * shared_out

    if not need_aux:
        return y, 0.0
    # Switch-style load-balance loss over the true (unpadded) experts; the
    # reference's mean over tokens of the one-hot rows is each expert's
    # count (exact in float32) over N
    me = probs.reshape(N, E)[:, :m.num_experts].mean(dim=0)
    counts = torch.zeros(E, device=x.device).scatter_add_(
        0, topi.reshape(-1), torch.ones(topi.numel(), device=x.device))
    ce = (counts / N)[:m.num_experts] / k
    aux = m.num_experts * torch.sum(me * ce)
    return y, aux


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _ffn(lp, cfg, h, need_aux: bool = False):
    """The block's feed-forward half: (y, aux), aux 0.0 for the dense MLP
    and unless ``need_aux``."""
    if cfg.moe:
        return moe_apply(lp["moe"], cfg, h, need_aux=need_aux)
    mp = lp["mlp"]
    return L.swiglu(h, mp["w_gate"], mp["w_up"], mp["w_down"]), 0.0


def prefix_attention(q, k, v, prefix_len: int):
    """Prefix-LM attention (paligemma): bidirectional over the first
    ``prefix_len`` positions, causal after them.  q: (B, H, T, Dh); k, v:
    (B, Hkv, T, Dh).  Two K15 calls: the prefix's queries against the
    prefix's keys, unmasked; the rest against every key, causal from
    ``q_offset = prefix_len``."""
    P = prefix_len
    o_pre = ops.flash_attention(q[:, :, :P], k[:, :, :P], v[:, :, :P],
                                causal=False)
    o_suf = ops.flash_attention(q[:, :, P:], k, v, causal=True, q_offset=P)
    return torch.cat([o_pre, o_suf], dim=2)


def _attention(lp, cfg, h, positions, prefix_len: int):
    """The block's attention over the whole sequence on K15 (prefix-LM
    when ``prefix_len > 0``); returns (its output (B, T, D), k, v)."""
    q, k, v = L.attn_qkv(lp["attn"], cfg, h, positions)
    if prefix_len > 0:
        o = prefix_attention(q, k, v, prefix_len)
    else:
        o = ops.flash_attention(q, k, v, causal=True)
    return L.attn_out(lp["attn"], o), k, v


def block_apply(lp, cfg, x, positions, *, prefix_len: int = 0):
    """One decoder block, train/prefill path.  x: (B, T, D) → (x, aux)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + _attention(lp, cfg, h, positions, prefix_len)[0]
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, aux = _ffn(lp, cfg, h, need_aux=True)
    return x + y, aux


def _quantize(t):
    """(B, Hkv, 1, Dh) → int8 rows and their float32 scales (B, Hkv, 1):
    the scale ``max|t| / 127`` floored at 1e-8, the values rounded half
    to even (``jnp.round``'s rounding) and clipped to ±127."""
    tf = t.float()
    s = (tf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q8 = torch.round(tf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q8, s


def _quant_decode_attention(p, cfg, x, ck, cv, ks, vs, pos: int):
    """int8-KV decode attention (grouped-query, one position ``pos`` for
    every lane), the reference's ``_quant_decode_attention``: the new K/V
    rows are quantized at write (:func:`_quantize`, each write clamped
    into the cache as ``dynamic_update_slice`` clamps it), and the scales
    fold into the contractions on the key axis, so the cache is read as
    int8 (the keys widened to the compute dtype, exactly; the values to
    float32).  ck/cv: (B, Hkv, Tmax, Dh) int8, ks/vs: (B, Hkv, Tmax)
    float32, written in place.  Returns (y, ck, cv, ks, vs)."""
    B = x.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Tmax = ck.shape[2]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = L.attn_qkv(p, cfg, x, positions)
    k8, k_s = _quantize(k)
    v8, v_s = _quantize(v)
    start = min(max(pos, 0), Tmax - 1)
    ck[:, :, start:start + 1] = k8
    cv[:, :, start:start + 1] = v8
    ks[:, :, start:start + 1] = k_s
    vs[:, :, start:start + 1] = v_s
    G = Hq // Hkv
    qg = q.reshape(B * Hkv, G, Dh)
    s = L.grouped_scores(qg, ck.reshape(B * Hkv, Tmax, Dh).to(q.dtype))
    s = (s.view(B, Hkv, G, Tmax) * ks[:, :, None, :]) * (Dh ** -0.5)
    mask = torch.arange(Tmax, device=x.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, L.NEG_INF)
    w = torch.softmax(s, dim=-1) * vs[:, :, None, :]
    o = L.grouped_values(w.view(B * Hkv, G, Tmax),
                         cv.reshape(B * Hkv, Tmax, Dh))
    o = o.view(B, Hq, 1, Dh).to(x.dtype)
    return L.attn_out(p, o), ck, cv, ks, vs


def block_decode(lp, cfg, x, ck, cv, pos, ks=None, vs=None):
    """One-token decode. x: (B, 1, D); ck/cv: (B, Hkv, Tmax, Dh), written
    in place; ks/vs: the int8 cache's scales (B, Hkv, Tmax), or None for
    a wide cache.  The MoE layer routes every lane of the batch together,
    as the reference does (idle lanes compete for capacity).  Returns
    (x, ck, cv) for a wide cache, (x, ck, cv, ks, vs) for an int8 one."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if ks is not None:
        attn, ck, cv, ks, vs = _quant_decode_attention(
            lp["attn"], cfg, h, ck, cv, ks, vs, pos)
    else:
        attn, ck, cv = L.decode_attention(lp["attn"], cfg, h, ck, cv, pos)
    x = x + attn
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + _ffn(lp, cfg, h)[0]
    return (x, ck, cv) if ks is None else (x, ck, cv, ks, vs)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens):
    return cast(params["embed"])[tokens.long()]


def unembed(params, cfg, x):
    head = params.get("lm_head")
    w = cast(head) if head is not None else cast(params["embed"]).T
    return x @ w


def _embed(params, tokens, prefix_embeds):
    """Token embeddings, after ``prefix_embeds`` (B, P, D) cast to the
    compute dtype when given; and P (0 without a prefix)."""
    x = embed_tokens(params, tokens)
    if prefix_embeds is None:
        return x, 0
    return torch.cat([cast(prefix_embeds), x], dim=1), prefix_embeds.shape[1]


def forward(params, cfg, tokens, prefix_embeds: Optional[torch.Tensor] = None,
            remat_policy: str = "nothing"):
    """tokens: (B, T) → logits (B, T', V), aux (0.0 for the dense family;
    the MoE load-balance loss averaged over the layers).  With
    ``prefix_embeds`` (B, P, D) the sequence is [prefix; tokens], T' = P +
    T, and attention is prefix-LM.  Each layer under ``remat(...,
    remat_policy)``."""
    x, prefix_len = _embed(params, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer_fn(lp, x):
        return block_apply(lp, cfg, x, positions, prefix_len=prefix_len)

    layer_fn = remat(layer_fn, remat_policy)
    aux = 0.0
    for lp in params["layers"]:
        x, a = layer_fn(lp, x)
        aux += a
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), aux / max(cfg.n_layers, 1)


#: the products whose outputs ``remat(..., "dots")`` saves: the
#: unbatched matrix products, as ``dots_with_no_batch_dims_saveable``
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, policy: str):
    """``fn`` under activation checkpointing, the reference's ``remat``:
    ``"none"`` keeps every activation; ``"nothing"`` keeps only the
    inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant; the reference's
    ``nothing_saveable``); ``"dots"`` keeps the outputs of the unbatched
    matrix products as well (a selective checkpoint, the reference's
    ``dots_with_no_batch_dims_saveable``).  Any other name is
    ``"nothing"``, as in the reference.  Only where a graph is built
    (grad enabled, an input that requires a gradient): the serving paths
    call ``fn``.  The values do not depend on the policy."""
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            _checkpoint.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not ops.needs_graph(*L.tree_leaves(list(args))):
            return fn(*args)
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def train_loss(params, cfg, batch, remat_policy: str = "nothing"):
    """The mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``; the vlm's ``prefix_embeds``, whose positions take no
    loss), plus 0.01 of the MoE load-balance loss, as a float32 0-d
    tensor.  ``params`` are the float32 masters (each ``cast`` at its
    use)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("prefix_embeds"), remat_policy)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:          # vlm: loss on text only
        logits = logits[:, -labels.shape[1]:]
    return L.softmax_xent(logits, labels) + 0.01 * aux


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero KV cache ``{"k", "v"}``, each (L, B, Hkv, max_len, Dh) in
    ``dtype`` (default ``COMPUTE_DTYPE``) on ``device``.  Under
    ``FLAGS.decode_kv_int8``: ``k``, ``v`` in int8 and their float32
    scales ``k_s``, ``v_s`` of (L, B, Hkv, max_len)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if flags.FLAGS.decode_kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], device=device),
                "v_s": torch.zeros(shape[:-1], device=device)}
    dtype = L.COMPUTE_DTYPE if dtype is None else dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


_KV_AXES = ("layers", "cache_batch", "kv_heads", "kv_seq", None)


def cache_axes(cfg):
    """Each cache leaf's logical axes (the reference's ``Model.cache_axes``
    for the transformer families; the scales of the int8 cache under
    ``FLAGS.decode_kv_int8``, read at call time)."""
    del cfg
    axes = {"k": _KV_AXES, "v": _KV_AXES}
    if flags.FLAGS.decode_kv_int8:
        axes.update(k_s=_KV_AXES[:-1], v_s=_KV_AXES[:-1])
    return axes


def decode_step(params, cfg, cache, tokens, pos):
    """tokens: (B, 1); pos: an int, or (B,) per-lane positions →
    (logits (B, 1, V), cache), the cache written in place.  An int8 cache
    (one with ``k_s``, as the reference chooses) takes one int position:
    per-lane positions raise a ``ValueError``, as the reference's
    broadcast of (B,) positions into its one-row write does."""
    x = embed_tokens(params, tokens)
    int8 = "k_s" in cache
    if int8:
        if torch.is_tensor(pos) and pos.dim() > 0:
            raise ValueError(
                f"the int8 KV cache decodes every lane at one position; got "
                f"per-lane positions of shape {tuple(pos.shape)} (the "
                "reference: Incompatible shapes for broadcasting)")
        pos = int(pos)
    for i, lp in enumerate(params["layers"]):
        scales = (cache["k_s"][i], cache["v_s"][i]) if int8 else ()
        x = block_decode(lp, cfg, x, cache["k"][i], cache["v"][i], pos,
                         *scales)[0]
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), cache


def chunk_step(params, cfg, cache, tokens, pos: int):
    """Score a k-token chunk against the cache (speculative-decode verify).

    tokens: (B, k); pos: an int, the chunk occupies [pos, pos+k).  Returns
    (logits (B, k, V), the cache with the chunk's K/V written in place).
    Positions >= pos+k in the cache are ignored by masking, so a later
    overwrite at a smaller pos implements rollback (the paper's TM discard).
    """
    x = embed_tokens(params, tokens)
    B, k, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Tmax = cache["k"].shape[3]
    pos = int(pos)
    positions = pos + torch.arange(k, device=x.device)
    start = min(max(pos, 0), Tmax - k)      # dynamic_update_slice's clamp
    cols = torch.arange(Tmax, device=x.device)[None, None, None, :]
    rows = positions[None, None, :, None]
    for i, lp in enumerate(params["layers"]):
        ck, cv = cache["k"][i], cache["v"][i]
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, kk, vv = L.attn_qkv(lp["attn"], cfg, h, positions)
        ck[:, :, start:start + k] = kk.to(ck.dtype)
        cv[:, :, start:start + k] = vv.to(cv.dtype)
        kr = ck.repeat_interleave(Hq // Hkv, dim=1)
        vr = cv.repeat_interleave(Hq // Hkv, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * Dh ** -0.5
        s = torch.where(cols <= rows, s, L.NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", w, vr.float()).to(x.dtype)
        x = x + L.attn_out(lp["attn"], o)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(lp, cfg, h)[0]
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), cache


def prefill(params, cfg, tokens, max_len: int,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Run the whole prompt, returning logits (B, T, V) and a KV cache of
    ``max_len`` positions holding the prompt's K/V (zeros after it).  With
    ``prefix_embeds`` (B, P, D) the prompt is [prefix; tokens] (T counts
    both), attention is prefix-LM, and the cache holds the prefix's K/V at
    positions [0, P)."""
    x, prefix_len = _embed(params, tokens, prefix_embeds)
    B, T, _ = x.shape
    if T > max_len:
        raise ValueError(f"prompt of {T} tokens exceeds max_len {max_len}")
    positions = torch.arange(T, device=x.device)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, max_len, cfg.head_dim)
    cache = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
    for i, lp in enumerate(params["layers"]):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn, k, v = _attention(lp, cfg, h, positions, prefix_len)
        x = x + attn
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(lp, cfg, h)[0]
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), cache
