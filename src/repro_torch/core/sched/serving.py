"""Continuous-batching serving engine scheduled HTS-style.

Port of the reference's ``core/sched/serving.py``.  Mapping from the
paper's scheduler to a model server:

  decode slots (batch lanes)   ↔ accelerator functional units
  slot busy bitmap             ↔ Accelerator Status Register (ASR)
  request queue                ↔ Task Queue
  admission of a request       ↔ Task Dispatch (out-of-order: any free slot
                                 takes the oldest *ready* request — requests
                                 have no inter-dependencies, the common case)
  finished-request retirement  ↔ CDB completion broadcast
  "naive" mode                 ↔ the paper's Naive baseline: the whole batch
                                 is drained before new requests are admitted
                                 (static batching).

The engine drives the ``decode_step`` of a registry Model; prompts are
absorbed token-by-token into the slot's cache lane.  The transformer
families (dense, moe, and vlm serving text alone) decode at per-lane
positions (true continuous batching); the others at one position, the
largest over the active slots, as in the reference (their callers submit
prompts of equal length; whisper's cross K/V is zeroed with the rest of a
slot's cache on admission, as the reference zeroes it).  Every slot decodes each step, idle ones on
token 0: a MoE model routes them with the rest, as the reference does.  The cache is written in
place, and the step's argmax is read back to the host once per step, as
the reference reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    slot_busy_steps: int = 0
    completed: int = 0

    def utilization(self, n_slots: int) -> float:
        return self.slot_busy_steps / max(self.steps * n_slots, 1)


class Server:
    """Slot-based continuous batching over one decode step."""

    def __init__(self, model, params, n_slots: int, max_len: int,
                 policy: str = "ooo", eos: Optional[int] = None):
        if policy not in ("ooo", "naive"):
            raise ValueError(f"policy must be 'ooo' or 'naive', got {policy!r}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.policy = policy
        self.eos = eos
        self.cache = model.init_cache(n_slots, max_len)
        # ASR: per-slot state
        self.busy = [False] * n_slots            # the ASR bitmap
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = [0] * n_slots            # per-slot sequence position
        self.slot_feed = [0] * n_slots           # next prompt index to feed
        self.queue: list[Request] = []
        self.stats = ServeStats()

    # -- task queue ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        if self.policy == "naive" and any(self.busy):
            return                                # drain before re-admission
        for s in range(self.n_slots):
            if not self.busy[s] and self.queue:
                req = self.queue.pop(0)
                self.busy[s] = True               # ASR set
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_feed[s] = 0
                self._reset_slot_cache(s)

    def _reset_slot_cache(self, s: int):
        """Zero slot ``s`` of every cache tensor, along the axis that
        ``model.cache_axes`` names ``"cache_batch"``."""
        for name, axes in self.model.cache_axes.items():
            self.cache[name].select(axes.index("cache_batch"), s).zero_()

    # -- one engine step: feed every busy slot one token --------------------
    def step(self):
        self._admit()
        self.stats.steps += 1
        active = [s for s in range(self.n_slots) if self.busy[s]]
        if not active:
            return
        self.stats.slot_busy_steps += len(active)
        feed = [[0] for _ in range(self.n_slots)]
        for s in active:
            req = self.slot_req[s]
            if self.slot_feed[s] < len(req.prompt):
                feed[s][0] = req.prompt[self.slot_feed[s]]
            else:
                feed[s][0] = req.out[-1]
        dev = self.model.device
        tokens = torch.tensor(feed, dtype=torch.int32, device=dev)
        if self.model.cfg.family in ("dense", "moe", "vlm"):
            pos = torch.tensor(self.slot_pos, dtype=torch.int32, device=dev)
        else:
            pos = max(self.slot_pos[s] for s in active)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    tokens, pos)
        nxt = logits[:, -1].argmax(dim=-1).tolist()
        for s in active:
            req = self.slot_req[s]
            self.slot_pos[s] += 1
            if self.slot_feed[s] < len(req.prompt):
                self.slot_feed[s] += 1
                if self.slot_feed[s] == len(req.prompt):
                    req.out.append(int(nxt[s]))
            else:
                req.out.append(int(nxt[s]))
            done = (len(req.out) >= req.max_new
                    or (self.eos is not None and req.out
                        and req.out[-1] == self.eos)
                    or self.slot_pos[s] >= self.max_len - 1)
            if done and len(req.out) > 0 and \
                    self.slot_feed[s] >= len(req.prompt):
                req.done = True                   # CDB retirement
                self.busy[s] = False              # ASR clear
                self.slot_req[s] = None
                self.stats.completed += 1

    def run(self, max_steps: int = 10_000) -> ServeStats:
        while (self.queue or any(self.busy)) and self.stats.steps < max_steps:
            self.step()
        return self.stats
