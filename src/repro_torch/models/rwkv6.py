"""RWKV-6 "Finch" (attention-free) language model, the ``ssm`` family.

Port of the reference's ``models/rwkv6.py``: time mix with a
data-dependent decay (low-rank LoRA on w), the WKV6 recurrence on K17
(``ops.rwkv6_scan``, once a layer in :func:`forward`), squared-ReLU channel
mix.  Decode carries O(1) state per layer, the (H, K, V) WKV state and the
two token-shift registers, and steps it in plain torch, as the reference
steps it in jnp.  ``params["layers"]`` is a list of per-layer dicts; the
cache keeps the reference's layout and is written in place.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import layers as L
from . import transformer as T
from .layers import Spec, cast

DECAY_LORA = 64


def block_template(cfg) -> dict:
    D = cfg.d_model
    H, K = cfg.n_heads, cfg.ssm.d_state
    V = cfg.ssm.head_dim
    F = cfg.d_ff
    return {
        "ln1": Spec((D,), (None,), init="ones"),
        "att": {
            "mu": Spec((5, D), (None, None), init="zeros"),   # r k v w g mixes
            "wr": Spec((D, H * K), ("embed_fsdp", "heads")),
            "wk": Spec((D, H * K), ("embed_fsdp", "heads")),
            "wv": Spec((D, H * V), ("embed_fsdp", "heads")),
            "wg": Spec((D, H * V), ("embed_fsdp", "heads")),
            "w0": Spec((H * K,), ("heads",), init="zeros"),
            "wa": Spec((D, DECAY_LORA), ("embed_fsdp", None)),
            "wb": Spec((DECAY_LORA, H * K), (None, "heads")),
            "u": Spec((H, K), ("heads", None)),
            "ln_x": Spec((H * V,), ("heads",), init="ones"),
            "wo": Spec((H * V, D), ("heads", "embed_fsdp")),
        },
        "ln2": Spec((D,), (None,), init="ones"),
        "ffn": {
            "mu": Spec((2, D), (None, None), init="zeros"),   # k r mixes
            "wk": Spec((D, F), ("embed_fsdp", "mlp")),
            "wv": Spec((F, D), ("mlp", "embed_fsdp")),
            "wr": Spec((D, D), ("embed_fsdp", None)),
        },
    }


#: the leaves the reference reads without ``cast``, held in float32:
#: ``att.w0`` (``_decay``); the stacked subtrees with their number of
#: leading stacked axes
FLOAT32_LEAVES = frozenset({"w0"})
STACKED = {"layers": 1}


def template(cfg) -> dict:
    return {
        "embed": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"),
                      scale=1.0),
        "layers": L.stack_layers(block_template(cfg), cfg.n_layers),
        "final_norm": Spec((cfg.d_model,), (None,), init="ones"),
        "lm_head": Spec((cfg.d_model, cfg.vocab), ("embed_fsdp", "vocab")),
    }


def _mix(x, x_prev_seq, mu):
    """Token shift: x + mu * (shift(x) - x)."""
    return x + mu * (x_prev_seq - x)


def _decay(att, xw):
    """exp(-exp(w0 + tanh(xw wa) wb)): the float32 ``w0`` promotes the sum
    to float32, as in the reference; rounded back to xw's dtype."""
    w = att["w0"] + torch.tanh(xw @ cast(att["wa"])) @ cast(att["wb"])
    return torch.exp(-torch.exp(w.float())).to(xw.dtype)


def _head_norm(o, scale, H, V, eps):
    B, T_ = o.shape[:2]
    o = o.reshape(B, T_, H, V)
    o = o * torch.rsqrt(o.float().square().mean(-1, keepdim=True)
                        + eps).to(o.dtype)
    return o.reshape(B, T_, H * V) * cast(scale)


def time_mix(att, cfg, x, x_shift):
    """x: (B, T, D); x_shift: x shifted right one step (first row = prev
    state).  One K17 launch."""
    H, K, V = cfg.n_heads, cfg.ssm.d_state, cfg.ssm.head_dim
    B, T_, D = x.shape
    mu = cast(att["mu"])
    xr, xk, xv, xw, xg = (_mix(x, x_shift, mu[i]) for i in range(5))
    r = (xr @ cast(att["wr"])).reshape(B, T_, H, K)
    k = (xk @ cast(att["wk"])).reshape(B, T_, H, K)
    v = (xv @ cast(att["wv"])).reshape(B, T_, H, V)
    w = _decay(att, xw).reshape(B, T_, H, K)
    g = L.silu(xg @ cast(att["wg"]))
    o = ops.rwkv6_scan(r, k, v, w, cast(att["u"]))
    o = _head_norm(o.reshape(B, T_, H * V), att["ln_x"], H, V, cfg.norm_eps)
    return (o * g) @ cast(att["wo"])


def channel_mix(ffn, x, x_shift):
    mu = cast(ffn["mu"])
    xk = _mix(x, x_shift, mu[0])
    xr = _mix(x, x_shift, mu[1])
    k = torch.square(torch.relu(xk @ cast(ffn["wk"])))
    return L.sigmoid(xr @ cast(ffn["wr"])) * (k @ cast(ffn["wv"]))


def _shift(x):
    """x shifted right one step along T, zero first row."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def forward(params, cfg, tokens, remat_policy: str = "nothing"):
    """tokens: (B, T) → logits (B, T, V), aux 0.0.  Each layer under
    ``T.remat(..., remat_policy)``."""
    x = T.embed_tokens(params, tokens)

    def layer_fn(lp, x):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + time_mix(lp["att"], cfg, h, _shift(h))
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + channel_mix(lp["ffn"], h, _shift(h))

    layer_fn = T.remat(layer_fn, remat_policy)
    for lp in params["layers"]:
        x = layer_fn(lp, x)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, cfg, x), 0.0


def train_loss(params, cfg, batch, remat_policy: str = "nothing"):
    """The mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``), a float32 0-d tensor; ``params`` the float32 masters."""
    logits, _ = forward(params, cfg, batch["tokens"], remat_policy)
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------------
# decode: O(1) recurrent state
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero state ``{"att_x", "ffn_x"}`` (L, B, D) in ``dtype`` (default
    ``COMPUTE_DTYPE``) and ``{"S"}`` (L, B, H, K, V) in float32."""
    del max_len   # state is O(1) in sequence length
    dtype = L.COMPUTE_DTYPE if dtype is None else dtype
    H, K, V = cfg.n_heads, cfg.ssm.d_state, cfg.ssm.head_dim
    Lr, D = cfg.n_layers, cfg.d_model
    return {
        "att_x": torch.zeros(Lr, batch, D, dtype=dtype, device=device),
        "ffn_x": torch.zeros(Lr, batch, D, dtype=dtype, device=device),
        "S": torch.zeros(Lr, batch, H, K, V, dtype=torch.float32,
                         device=device),
    }


def cache_axes(cfg):
    del cfg
    return {
        "att_x": ("layers", "cache_batch", None),
        "ffn_x": ("layers", "cache_batch", None),
        "S": ("layers", "cache_batch", "heads", None, None),
    }


def decode_step(params, cfg, cache, tokens, pos):
    """tokens: (B, 1) → (logits (B, 1, V), cache), the cache written in
    place.  ``pos`` is unused (the state is position-free)."""
    del pos
    H, K, V = cfg.n_heads, cfg.ssm.d_state, cfg.ssm.head_dim
    x = T.embed_tokens(params, tokens)                       # (B, 1, D)
    B = x.shape[0]
    for i, lp in enumerate(params["layers"]):
        ax, fx, S = cache["att_x"][i], cache["ffn_x"][i], cache["S"][i]
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        h1 = h[:, 0]
        att = lp["att"]
        mu = cast(att["mu"])
        xr, xk, xv, xw, xg = (h1 + mu[j] * (ax - h1) for j in range(5))
        r = (xr @ cast(att["wr"])).reshape(B, H, K)
        k = (xk @ cast(att["wk"])).reshape(B, H, K)
        v = (xv @ cast(att["wv"])).reshape(B, H, V)
        w = _decay(att, xw[:, None])[:, 0].reshape(B, H, K)
        g = L.silu(xg @ cast(att["wg"]))
        kv = k[..., None] * v[..., None, :].float()
        u = cast(att["u"]).float()
        o = torch.einsum("bhk,bhkv->bhv", r.float(),
                         S + u[None, :, :, None] * kv)
        S_new = w[..., None].float() * S + kv
        o = _head_norm(o.reshape(B, 1, H * V).to(x.dtype), att["ln_x"], H, V,
                       cfg.norm_eps)
        x = x + ((o[:, 0] * g) @ cast(att["wo"]))[:, None]
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        h1n = h[:, 0]
        ffn = lp["ffn"]
        mu2 = cast(ffn["mu"])
        xkf = h1n + mu2[0] * (fx - h1n)
        xrf = h1n + mu2[1] * (fx - h1n)
        kf = torch.square(torch.relu(xkf @ cast(ffn["wk"])))
        y = L.sigmoid(xrf @ cast(ffn["wr"])) * (kf @ cast(ffn["wv"]))
        x = x + y[:, None]
        ax.copy_(h1)
        fx.copy_(h1n)
        S.copy_(S_new)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, cfg, x), cache
