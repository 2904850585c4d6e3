"""Whisper-style encoder-decoder (the audio family).

Port of the reference's ``models/whisper.py``.  The conv frontend is a
stub there and here: the encoder takes frame embeddings (B, T, D).  The
encoder adds sinusoidal positions and attends bidirectionally (K15,
unmasked); the decoder's causal self-attention uses RoPE (the reference's
departure from Whisper's learned positions) and attends across to the
encoder states (K15, unmasked, Tq ≠ Tk).  ``params["enc_layers"]`` and
``params["dec_layers"]`` are lists of per-layer dicts, walked by Python
loops.

Decode keeps a self-attention KV cache and the cross K/V, ``{"k", "v",
"xk", "xv"}``, each (L, B, Hkv, max_len, Dh): one ``max_len`` for all
four, as in the reference, so cross K/V from Tenc frames fills Tenc rows
and zeros after them, and ``decode_step``'s cross attention runs
unmasked over all ``max_len`` rows, the zero rows included, as the
reference's does.  :func:`fill_cross_cache` writes the cross K/V from
encoder states (the reference's tests compute it inline).
:func:`train_loss` runs the decoder's cross-entropy through
:func:`encode` and :func:`decode_seq`.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import layers as L
from . import transformer as T
from .layers import Spec, cast

#: the leaves the reference reads without ``cast`` (none here), and the
#: stacked subtrees with their number of leading stacked axes
FLOAT32_LEAVES = frozenset()
STACKED = {"enc_layers": 1, "dec_layers": 1}


def enc_block_template(cfg) -> dict:
    return {
        "ln1": Spec((cfg.d_model,), (None,), init="ones"),
        "attn": L.attn_template(cfg),
        "ln2": Spec((cfg.d_model,), (None,), init="ones"),
        "mlp": {
            "w_up": Spec((cfg.d_model, cfg.d_ff), ("embed_fsdp", "mlp")),
            "b_up": Spec((cfg.d_ff,), ("mlp",), init="zeros"),
            "w_down": Spec((cfg.d_ff, cfg.d_model), ("mlp", "embed_fsdp")),
            "b_down": Spec((cfg.d_model,), (None,), init="zeros"),
        },
    }


def dec_block_template(cfg) -> dict:
    t = enc_block_template(cfg)
    t["ln_x"] = Spec((cfg.d_model,), (None,), init="ones")
    t["xattn"] = L.attn_template(cfg)
    return t


def template(cfg) -> dict:
    return {
        "embed": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"),
                      scale=1.0),
        "enc_layers": L.stack_layers(enc_block_template(cfg), cfg.enc_layers),
        "enc_norm": Spec((cfg.d_model,), (None,), init="ones"),
        "dec_layers": L.stack_layers(dec_block_template(cfg), cfg.n_layers),
        "final_norm": Spec((cfg.d_model,), (None,), init="ones"),
        "lm_head": Spec((cfg.d_model, cfg.vocab), ("embed_fsdp", "vocab")),
    }


def _sinusoid(T_, D, device=None):
    """Sinusoidal positions (T_, D) in float32: sines, then cosines, of
    ``pos / 10000 ** (2·dim / D)``."""
    pos = torch.arange(T_, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(D // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mlp(lp, x):
    m = lp["mlp"]
    return L.gelu_mlp(x, m["w_up"], m["b_up"], m["w_down"], m["b_down"])


def encode(params, cfg, frames, remat_policy: str = "nothing"):
    """frames: (B, T, D) stub embeddings → encoder states (B, T, D) in
    the compute dtype.  K15 once a layer, unmasked; each layer under
    ``T.remat(..., remat_policy)``."""
    x = cast(frames) + cast(_sinusoid(frames.shape[1], cfg.d_model,
                                      frames.device))[None]
    positions = torch.arange(x.shape[1], device=x.device)

    def layer_fn(lp, x):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + L.self_attention(lp["attn"], cfg, h, positions, causal=False,
                                 use_rope=False)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + _mlp(lp, h)

    layer_fn = T.remat(layer_fn, remat_policy)
    for lp in params["enc_layers"]:
        x = layer_fn(lp, x)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(p, cfg, enc):
    """The cross attention's k and v of encoder states: (B, Hkv, Te, Dh)."""
    B = enc.shape[0]
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    k = L.linear(enc, p["wk"], p.get("bk")).reshape(B, -1, Hkv, Dh)
    v = L.linear(enc, p["wv"], p.get("bv")).reshape(B, -1, Hkv, Dh)
    return k.transpose(1, 2), v.transpose(1, 2)


def _cross_attention(lp, cfg, x, enc):
    """q from decoder x; k/v from encoder states; K15 unmasked."""
    B, Tq, _ = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q = L.linear(x, lp["wq"], lp.get("bq")).reshape(B, Tq, H, Dh)
    k, v = _cross_kv(lp, cfg, enc)
    o = ops.flash_attention(q.transpose(1, 2), k, v, causal=False)
    return L.attn_out(lp, o)


def decode_seq(params, cfg, tokens, enc, remat_policy: str = "nothing"):
    """Teacher-forced decoder pass. tokens: (B, T); enc: (B, Te, D) →
    logits (B, T, V).  K15 twice a layer: causal self-attention, then
    cross attention to ``enc``; each layer under ``T.remat(...,
    remat_policy)``."""
    x = T.embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer_fn(lp, x, enc):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + L.self_attention(lp["attn"], cfg, h, positions, causal=True)
        h = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        x = x + _cross_attention(lp["xattn"], cfg, h, enc)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + _mlp(lp, h)

    layer_fn = T.remat(layer_fn, remat_policy)
    for lp in params["dec_layers"]:
        x = layer_fn(lp, x, enc)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, cfg, x)


def forward(params, cfg, tokens, frames):
    """The family-uniform sequence path (the reference's prefill for the
    audio family, ``launch/dryrun.py`` ``_prefill_logits``): logits (B, T,
    V) of ``decode_seq(tokens, encode(frames))``, and aux 0.0."""
    return decode_seq(params, cfg, tokens, encode(params, cfg, frames)), 0.0


def train_loss(params, cfg, batch, remat_policy: str = "nothing"):
    """The mean next-token cross-entropy of the decoder on ``batch``
    (``frames``, ``tokens``, ``labels``) through ``encode`` and
    ``decode_seq``, a float32 0-d tensor; ``params`` the float32
    masters."""
    enc = encode(params, cfg, batch["frames"], remat_policy)
    logits = decode_seq(params, cfg, batch["tokens"], enc, remat_policy)
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero ``{"k", "v", "xk", "xv"}``, each (L, B, Hkv, max_len, Dh) in
    ``dtype`` (default ``COMPUTE_DTYPE``) on ``device``."""
    dtype = L.COMPUTE_DTYPE if dtype is None else dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name in ("k", "v", "xk", "xv")}


def cache_axes(cfg):
    del cfg
    a = ("layers", "cache_batch", "kv_heads", "kv_seq", None)
    return {"k": a, "v": a, "xk": a, "xv": a}


def fill_cross_cache(params, cfg, cache, enc):
    """Write each decoder layer's cross K/V of encoder states ``enc`` (B,
    Te, D) into ``cache["xk"]``/``cache["xv"]`` in place: rows [0, Te),
    zeros after them (the reference tests' prefill-side computation).
    Returns the cache."""
    Te = enc.shape[1]
    if Te > cache["xk"].shape[3]:
        raise ValueError(f"{Te} encoder frames exceed the cache's "
                         f"{cache['xk'].shape[3]} positions")
    for i, lp in enumerate(params["dec_layers"]):
        k, v = _cross_kv(lp["xattn"], cfg, enc)
        for name, t in (("xk", k), ("xv", v)):
            cache[name][i].zero_()
            cache[name][i, :, :, :Te] = t.to(cache[name].dtype)
    return cache


def decode_step(params, cfg, cache, tokens, pos):
    """tokens: (B, 1); pos: an int (the reference serves this family at
    one position) → (logits (B, 1, V), cache), the self-attention K/V
    written in place.  The cross attention is plain float32 over every
    row of the cross K/V, GQA repeated, as in the reference."""
    x = T.embed_tokens(params, tokens)
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = x.shape[0]
    for i, lp in enumerate(params["dec_layers"]):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn, _, _ = L.decode_attention(lp["attn"], cfg, h, cache["k"][i],
                                        cache["v"][i], pos)
        x = x + attn
        h = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        q = L.linear(h, lp["xattn"]["wq"]).reshape(B, 1, H, Dh).transpose(1, 2)
        kk = cache["xk"][i].repeat_interleave(H // Hkv, dim=1)
        vv = cache["xv"][i].repeat_interleave(H // Hkv, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) \
            * (Dh ** -0.5)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", w, vv.float()).to(x.dtype)
        x = x + L.attn_out(lp["xattn"], o)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(lp, h)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, cfg, x), cache
