"""Zamba2-style hybrid, the ``hybrid`` family: a Mamba-2 backbone with
alternating *shared* attention blocks every ``shared_attn_period`` layers.

Port of the reference's ``models/zamba2.py``.  Layer structure (L = 81,
period 6): 13 groups of [6 Mamba layers + one shared attention block],
then a 3-layer Mamba tail; group ``gi`` runs shared block ``gi %
n_shared_blocks`` (shared weights, a KV cache per site).  The sequence
path (:func:`forward`) runs K16 for each norm, K18 (``ops.mamba2_ssd``)
once a Mamba layer, and the dense model's ``block_apply`` for the shared
blocks, so K15 once a group.  Decode steps each Mamba layer's (conv
window, SSD state) and each site's KV cache in plain torch, as the
reference steps them in jnp; the cache keeps the reference's layout and is
written in place.  ``params["groups"]`` is a list of ``n_groups`` lists of
``period`` layer dicts, ``params["shared"]`` a list of the shared blocks,
``params["tail"]`` a list of layer dicts.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import layers as L
from . import transformer as T
from .layers import Spec, cast


def _dims(cfg):
    d_in = cfg.ssm.expand * cfg.d_model
    H = d_in // cfg.ssm.head_dim
    N = cfg.ssm.d_state
    return d_in, H, N


def _layout(cfg):
    """(period, n_groups, tail layers)."""
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    return period, n_groups, cfg.n_layers - n_groups * period


def mamba_template(cfg) -> dict:
    D = cfg.d_model
    d_in, H, N = _dims(cfg)
    kconv = cfg.ssm.conv_kernel
    return {
        "ln": Spec((D,), (None,), init="ones"),
        "in_proj": Spec((D, 2 * d_in + 2 * N + H), ("embed_fsdp", "heads")),
        "conv_w": Spec((kconv, d_in + 2 * N), (None, "heads")),
        "conv_b": Spec((d_in + 2 * N,), ("heads",), init="zeros"),
        "a_log": Spec((H,), ("heads",), init="zeros"),
        "dt_bias": Spec((H,), ("heads",), init="zeros"),
        "d_skip": Spec((H,), ("heads",), init="zeros"),
        "out_norm": Spec((d_in,), ("heads",), init="ones"),
        "out_proj": Spec((d_in, D), ("heads", "embed_fsdp")),
    }


#: the leaves the reference reads without ``cast``, held in float32: the
#: decay's ``a_log`` and the step size's ``dt_bias``; the stacked subtrees
#: with their number of leading stacked axes, ``groups`` (n_groups,
#: period), ``shared`` and ``tail``
FLOAT32_LEAVES = frozenset({"a_log", "dt_bias"})
STACKED = {"groups": 2, "shared": 1, "tail": 1}


def template(cfg) -> dict:
    period, n_groups, tail = _layout(cfg)
    shared_block = {
        "ln1": Spec((cfg.d_model,), (None,), init="ones"),
        "attn": L.attn_template(cfg),
        "ln2": Spec((cfg.d_model,), (None,), init="ones"),
        "mlp": T.mlp_template(cfg),
    }
    t = {
        "embed": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"),
                      scale=1.0),
        "groups": L.stack_layers(
            L.stack_layers(mamba_template(cfg), period), n_groups),
        "shared": L.stack_layers(shared_block, cfg.n_shared_blocks),
        "final_norm": Spec((cfg.d_model,), (None,), init="ones"),
        "lm_head": Spec((cfg.d_model, cfg.vocab), ("embed_fsdp", "vocab")),
    }
    if tail:
        t["tail"] = L.stack_layers(mamba_template(cfg), tail)
    return t


def _split_proj(cfg, proj):
    d_in, H, N = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time. xbc: (B, T, C); w: (k, C).  The
    reference's Python ``sum`` of the k products, each add rounded in the
    input's dtype."""
    k = w.shape[0]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    return L.silu(out + b)


def _out_norm(y, lp, eps):
    """y · rsqrt(mean(y²) + eps) (float32 mean, rounded to y's dtype) ·
    out_norm."""
    y = y * torch.rsqrt(y.float().square().mean(-1, keepdim=True)
                        + eps).to(y.dtype)
    return y * cast(lp["out_norm"])


def mamba_apply(lp, cfg, x):
    """One Mamba-2 layer, sequence path. x: (B, T, D).  One K16 and one K18
    launch."""
    d_in, H, N = _dims(cfg)
    P = cfg.ssm.head_dim
    B, Tt, D = x.shape
    h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
    z, xbc, dt = _split_proj(cfg, h @ cast(lp["in_proj"]))
    xbc = _causal_conv(xbc, cast(lp["conv_w"]), cast(lp["conv_b"]))
    xin, bmat, cmat = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = L.softplus(dt.float() + lp["dt_bias"])                  # (B, T, H)
    a = -torch.exp(lp["a_log"]) * dt                             # ≤ 0
    xh = xin.reshape(B, Tt, H, P) * dt[..., None].to(xin.dtype)
    y = ops.mamba2_ssd(xh, a, bmat, cmat)                        # (B,T,H,P)
    y = y + xin.reshape(B, Tt, H, P) * cast(lp["d_skip"])[:, None]
    y = y.reshape(B, Tt, d_in) * L.silu(z)
    y = _out_norm(y, lp, cfg.norm_eps)
    return x + y @ cast(lp["out_proj"])


def forward(params, cfg, tokens, remat_policy: str = "nothing"):
    """tokens: (B, T) → logits (B, T, V), aux 0.0.  Each group (its Mamba
    layers and its shared block) under ``T.remat(..., remat_policy)``, as
    in the reference; the tail is not."""
    x = T.embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    def group_fn(group, shared, x):
        """A group's Mamba layers, then its shared attention block (K16,
        K15)."""
        for lp in group:
            x = mamba_apply(lp, cfg, x)
        return T.block_apply(shared, cfg, x, positions)[0]

    group_fn = T.remat(group_fn, remat_policy)
    for gi, group in enumerate(params["groups"]):
        x = group_fn(group, params["shared"][gi % cfg.n_shared_blocks], x)
    for lp in params.get("tail", ()):
        x = mamba_apply(lp, cfg, x)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, cfg, x), 0.0


def train_loss(params, cfg, batch, remat_policy: str = "nothing"):
    """The mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``), a float32 0-d tensor; ``params`` the float32 masters."""
    logits, _ = forward(params, cfg, batch["tokens"], remat_policy)
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero state: each Mamba layer's conv window (k-1, C) in ``dtype``
    (default ``COMPUTE_DTYPE``) and SSD state (H, N, P) in float32, as
    ``conv``/``ssd`` (n_groups, period, B, ...) and ``conv_tail``/
    ``ssd_tail`` (tail, B, ...); each group's KV cache ``attn_k``/
    ``attn_v`` (n_groups, B, Hkv, max_len, Dh)."""
    dtype = L.COMPUTE_DTYPE if dtype is None else dtype
    d_in, H, N = _dims(cfg)
    P = cfg.ssm.head_dim
    period, n_groups, tail = _layout(cfg)
    kconv = cfg.ssm.conv_kernel

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (n_groups, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    cache = {
        "conv": z(n_groups, period, batch, kconv - 1, d_in + 2 * N),
        "ssd": z(n_groups, period, batch, H, N, P, dt=torch.float32),
        "attn_k": z(*kv),
        "attn_v": z(*kv),
    }
    if tail:
        cache["conv_tail"] = z(tail, batch, kconv - 1, d_in + 2 * N)
        cache["ssd_tail"] = z(tail, batch, H, N, P, dt=torch.float32)
    return cache


def cache_axes(cfg):
    axes = {
        "conv": ("layers", None, "cache_batch", None, "heads"),
        "ssd": ("layers", None, "cache_batch", "heads", None, None),
        "attn_k": ("layers", "cache_batch", "kv_heads", "kv_seq", None),
        "attn_v": ("layers", "cache_batch", "kv_heads", "kv_seq", None),
    }
    if _layout(cfg)[2]:
        axes["conv_tail"] = ("layers", "cache_batch", None, "heads")
        axes["ssd_tail"] = ("layers", "cache_batch", "heads", None, None)
    return axes


def _mamba_decode(lp, cfg, x, conv_st, ssd_st):
    """x: (B, 1, D); conv_st: (B, k-1, C) and ssd_st: (B, H, N, P), both
    written in place.  Returns x."""
    d_in, H, N = _dims(cfg)
    P = cfg.ssm.head_dim
    B = x.shape[0]
    h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
    z, xbc, dt = _split_proj(cfg, h[:, 0] @ cast(lp["in_proj"]))
    window = torch.cat([conv_st, xbc[:, None]], dim=1)           # (B, k, C)
    conv = L.silu(torch.einsum("bkc,kc->bc", window, cast(lp["conv_w"]))
                  + cast(lp["conv_b"]))
    xin, bvec, cvec = torch.split(conv, [d_in, N, N], dim=-1)
    dtf = L.softplus(dt.float() + lp["dt_bias"])                  # (B, H)
    decay = torch.exp(-torch.exp(lp["a_log"]) * dtf)              # (B, H)
    xh = (xin.reshape(B, H, P) * dtf[..., None]).float()
    new = (decay[..., None, None] * ssd_st
           + bvec.float()[:, None, :, None] * xh[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cvec.float(), new)
    y = y.to(x.dtype) + xin.reshape(B, H, P) * cast(lp["d_skip"])[:, None]
    y = y.reshape(B, d_in) * L.silu(z)
    y = _out_norm(y, lp, cfg.norm_eps)
    conv_st.copy_(window[:, 1:])
    ssd_st.copy_(new)
    return x + (y @ cast(lp["out_proj"]))[:, None]


def _shared_decode(params, cfg, x, gi, ck, cv, pos):
    """Group ``gi``'s shared block, one token; ck/cv (B, Hkv, Tmax, Dh),
    the site's KV cache, written in place."""
    lp = params["shared"][gi % cfg.n_shared_blocks]
    return T.block_decode(lp, cfg, x, ck, cv, pos)[0]


def decode_step(params, cfg, cache, tokens, pos):
    """tokens: (B, 1); pos: an int, the position every lane writes its
    shared-attention K/V at → (logits (B, 1, V), cache), the cache written
    in place."""
    x = T.embed_tokens(params, tokens)                           # (B, 1, D)
    for gi, group in enumerate(params["groups"]):
        for j, lp in enumerate(group):
            x = _mamba_decode(lp, cfg, x, cache["conv"][gi, j],
                              cache["ssd"][gi, j])
        x = _shared_decode(params, cfg, x, gi, cache["attn_k"][gi],
                           cache["attn_v"][gi], pos)
    for i, lp in enumerate(params.get("tail", ())):
        x = _mamba_decode(lp, cfg, x, cache["conv_tail"][i],
                          cache["ssd_tail"][i])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, cfg, x), cache
