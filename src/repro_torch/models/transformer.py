"""Decoder-only transformer, dense family (yi / command-r / phi3 / qwen2).

Port of the reference's ``models/transformer.py`` for ``family ==
"dense"``.  The reference stacks the layers on a scanned axis; here
``params["layers"]`` is a list of per-layer dicts (views of the stacked
tensors the template draws), walked by a Python loop.  The KV cache keeps
the reference's layout, ``{"k", "v"}`` of (L, B, Hkv, Tmax, Dh), and is
written in place: ``decode_step`` and ``chunk_step`` return the cache they
were given.  The MoE layer (``moe_apply``) and the VLM prefix raise
``NotImplementedError`` naming their ROADMAP item (Queue 1 item 5c).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from ..runtime import flags
from . import layers as L
from .layers import Spec, cast

_MOE = "the MoE layer is not ported yet (ROADMAP Queue 1 item 5c)"
_PREFIX = "the VLM prefix is not ported yet (ROADMAP Queue 1 item 5c)"


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------
def mlp_template(cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": Spec((D, F), ("embed_fsdp", "mlp")),
        "w_up": Spec((D, F), ("embed_fsdp", "mlp")),
        "w_down": Spec((F, D), ("mlp", "embed_fsdp")),
    }


def block_template(cfg) -> dict:
    if cfg.moe:
        raise NotImplementedError(_MOE)
    return {
        "ln1": Spec((cfg.d_model,), (None,), init="ones"),
        "attn": L.attn_template(cfg),
        "ln2": Spec((cfg.d_model,), (None,), init="ones"),
        "mlp": mlp_template(cfg),
    }


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
# blocks
# ---------------------------------------------------------------------------
def _mlp(lp, h):
    m = lp["mlp"]
    return L.swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def block_apply(lp, cfg, x, positions):
    """One decoder block, train/prefill path.  x: (B, T, D) → (x, aux)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + L.self_attention(lp["attn"], cfg, h, positions)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(lp, h), 0.0


def block_decode(lp, cfg, x, ck, cv, pos):
    """One-token decode. x: (B, 1, D); ck/cv: (B, Hkv, Tmax, Dh), written
    in place."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn, ck, cv = L.decode_attention(lp["attn"], cfg, h, ck, cv, pos)
    x = x + attn
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(lp, h), ck, cv


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens):
    return cast(params["embed"])[tokens.long()]


def unembed(params, cfg, x):
    head = params.get("lm_head")
    w = cast(head) if head is not None else cast(params["embed"]).T
    return x @ w


def forward(params, cfg, tokens, prefix_embeds: Optional[torch.Tensor] = None):
    """tokens: (B, T) → logits (B, T, V), aux (0.0 for the dense family)."""
    if prefix_embeds is not None:
        raise NotImplementedError(_PREFIX)
    x = embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = 0.0
    for lp in params["layers"]:
        x, a = block_apply(lp, cfg, x, positions)
        aux += a
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), aux / max(cfg.n_layers, 1)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero KV cache ``{"k", "v"}``, each (L, B, Hkv, max_len, Dh) in
    ``dtype`` (default ``COMPUTE_DTYPE``) on ``device``."""
    if flags.FLAGS.decode_kv_int8:
        raise NotImplementedError(
            "FLAGS.decode_kv_int8 is not ported yet (ROADMAP Queue 1 item 5e, "
            "the decode flags)")
    dtype = L.COMPUTE_DTYPE if dtype is None else dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


_KV_AXES = ("layers", "cache_batch", "kv_heads", "kv_seq", None)


def cache_axes(cfg):
    """Each cache leaf's logical axes (the reference's
    ``Model.cache_axes`` for the dense family)."""
    del cfg
    return {"k": _KV_AXES, "v": _KV_AXES}


def decode_step(params, cfg, cache, tokens, pos):
    """tokens: (B, 1); pos: an int, or (B,) per-lane positions →
    (logits (B, 1, V), cache), the cache written in place."""
    x = embed_tokens(params, tokens)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = block_decode(lp, cfg, x, cache["k"][i], cache["v"][i], pos)
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
        x = x + _mlp(lp, h)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), cache


def prefill(params, cfg, tokens, max_len: int,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Run the whole prompt, returning logits (B, T, V) and a KV cache of
    ``max_len`` positions holding the prompt's K/V (zeros after it)."""
    if prefix_embeds is not None:
        raise NotImplementedError(_PREFIX)
    x = embed_tokens(params, tokens)
    B, T, _ = x.shape
    if T > max_len:
        raise ValueError(f"prompt of {T} tokens exceeds max_len {max_len}")
    positions = torch.arange(T, device=x.device)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, max_len, cfg.head_dim)
    cache = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
    for i, lp in enumerate(params["layers"]):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h, positions)
        o = ops.flash_attention(q, k, v, causal=True)
        x = x + L.attn_out(lp["attn"], o)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(lp, h)
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), cache
