"""Speculative decoding: the paper's speculative task execution mapped onto
serving.

Port of the reference's ``core/sched/specdecode.py``.  Correspondence with
the HTS mechanism (paper §IV-C3):

  draft tokens            ↔ speculative tasks (predicted not-taken path)
  KV-cache tail ≥ pos     ↔ Transactional Memory region (TLB-remapped outputs)
  target verify chunk     ↔ branch resolution (the BR read on the CDB)
  accepted prefix commit  ↔ TLB mappings retained on correct speculation
  pointer rollback        ↔ TLB entry discard on mis-speculation — the stale
                            K/V beyond the accept point is dead by masking
                            and overwritten by the next chunk, exactly like
                            discarded TM regions.

Greedy self-consistent variant: the emitted stream equals plain greedy
decoding of the target model.  The caches are written in place.  The
reference drafts into a copy of the draft cache and then replays the
accepted tokens into the original; here the draft writes the cache itself:
the replay rewrites every position it drafted at or before the accept
point, and the decode mask hides every position after it until it is
written again, so the two read the same K/V.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    chunks: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / max(self.proposed, 1)


def greedy_decode(model, params, prompt: np.ndarray, n_new: int,
                  max_len: int) -> np.ndarray:
    """Plain greedy decoding baseline (token-at-a-time): (B, n_new)."""
    B, P = prompt.shape
    cache = model.init_cache(B, max_len)
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                           device=model.device)
    out = []
    cur = toks[:, :1]
    for t in range(P + n_new - 1):
        logits, cache = model.decode_step(params, cache, cur, t)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        cur = toks[:, t + 1:t + 2] if t + 1 < P else nxt
        if t + 1 >= P:
            out.append(cur[:, 0])
    return torch.stack(out, dim=1).cpu().numpy()


def speculative_decode(target, t_params, draft, d_params, prompt: np.ndarray,
                       n_new: int, k: int, max_len: int
                       ) -> tuple[np.ndarray, SpecStats]:
    """Greedy speculative decoding (draft k, verify 1 chunk, rollback).

    ``target``/``draft`` are dense Models (draft is typically a
    reduced-depth config).  Returns (generated tokens (1, n_new), stats).
    """
    B, P = prompt.shape
    if B != 1:
        raise ValueError("the spec-decode path is per-sequence (slots batch "
                         "upstream): prompt must be (1, P)")
    t_cache = target.init_cache(B, max_len)
    d_cache = draft.init_cache(B, max_len)

    def ids(tokens):
        return torch.tensor([tokens], dtype=torch.int32, device=target.device)

    toks = [int(t) for t in np.asarray(prompt[0])]
    # prefill both models via chunk scoring (target) / stepping (draft)
    t_logits, t_cache = target.chunk_step(t_params, t_cache, ids(toks), 0)
    for i in range(P):
        _, d_cache = draft.decode_step(d_params, d_cache, ids([toks[i]]), i)
    next_tok = int(t_logits[0, -1].argmax())

    stats = SpecStats()
    generated = [next_tok]
    # Invariant at loop top: caches hold K/V for positions [0, pos);
    # sequence[pos] = generated[-1] = next_tok (K/V not yet written — it is
    # chunk[0] of the next verify, or the first draft feed).
    pos = P
    d_pos = P
    while len(generated) < n_new:
        # --- draft proposes k tokens (speculative tasks)
        proposal = []
        cur = next_tok
        for j in range(k):
            lg, d_cache = draft.decode_step(d_params, d_cache, ids([cur]),
                                            d_pos + j)
            cur = int(lg[0, -1].argmax())
            proposal.append(cur)
        # --- target verifies chunk = [next_tok, proposal[:-1]] (branch resolve)
        chunk = [next_tok] + proposal[:-1]
        lg, t_cache = target.chunk_step(t_params, t_cache, ids(chunk), pos)
        argmax = lg[0].argmax(dim=-1).tolist()
        # accepted = target tokens up to and including the first mismatch
        m = k - 1
        for j in range(k):
            if proposal[j] != argmax[j]:
                m = j
                break
        accepted = argmax[:m + 1]
        stats.chunks += 1
        stats.proposed += k
        stats.accepted += sum(1 for j in range(m + 1)
                              if proposal[j] == argmax[j])
        generated.extend(accepted)
        # --- commit/rollback: pointer advances by |accepted|; chunk K/V
        #     beyond it is dead by masking and overwritten next round (the
        #     paper's TM discard on mis-speculation).
        replay = [next_tok] + accepted[:-1]     # sequence[d_pos : pos+|acc|]
        for j, tk in enumerate(replay):
            _, d_cache = draft.decode_step(d_params, d_cache, ids([tk]),
                                           d_pos + j)
        pos += len(accepted)
        d_pos += len(replay)
        next_tok = generated[-1]

    return np.asarray([generated[:n_new]]), stats
