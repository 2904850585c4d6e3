"""Train step and fault-tolerant training loop, on one device.

Port of the reference's ``runtime/train.py``.  ``make_train_step`` builds
the step: the loss on float32 masters (each cast to the compute dtype at
its use, so the model's matrix products and kernels run in bfloat16),
optional gradient accumulation (microbatches averaged in float32), AdamW
with global-norm clipping on a warmup-cosine schedule, and the metrics
``loss``, ``grad_norm``, ``lr`` and ``clip``.  The step updates the state
in place and returns it, as the reference donates its state to the jitted
step.  The kernels' gradients are their plain versions' VJPs
(``kernels.ops._RefVJP``), as the reference's are.

``TrainLoop`` adds checkpoint and restart (exact resume: the data is a
function of (seed, step)), asynchronous checkpoints, retry on failure up
to ``max_restarts``, and a straggler watchdog.

The reference's ``abstract_state``, ``state_pspecs``, ``batch_pspecs`` and
``jit_train_step`` place the state and the batch under a mesh's
shardings; they wait for ``sharding/rules.py`` and ``launch/mesh.py``
(ROADMAP, the tail).  On one device the step is ``make_train_step`` as it
is.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import ckpt as ckpt_lib
from ..data.pipeline import shard_batch
from ..models import layers as L
from ..optim import adamw, schedule

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    remat_policy: str = "nothing"
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1            # gradient-accumulation factor
    ckpt_every: int = 50
    ckpt_keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 2.0    # step slower than factor×median → flagged


def init_state(model, seed: int = 0, device=None):
    """``{"params": float32 masters, "opt": AdamW's state}`` on
    ``device`` (default the model's): the masters drawn from ``seed``
    (:meth:`Model.init_masters`); with ``device="meta"`` the same tree of
    empty tensors, a template for ``ckpt.restore``."""
    if device is not None and torch.device(device).type == "meta":
        params = L.tree_map(
            lambda t: torch.empty_like(t, device="meta"),
            _meta_masters(model))
    else:
        params = model.init_masters(seed)
        if device is not None:
            params = L.tree_map(lambda t: t.to(device), params)
    return {"params": params, "opt": adamw.init(params)}


def _meta_masters(model):
    """The masters' tree of shapes, as float32 tensors on ``meta``."""
    spec = L.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        model.template)
    return L.unstack_params(spec, model.impl.STACKED)


def loss_and_grads(model, params, batch, remat_policy: str = "nothing"):
    """The train loss of ``batch`` (detached) and its gradient with respect
    to each master, in ``tree_leaves`` order: None where the loss does not
    read a leaf (``make_train_step`` takes zeros there, as ``jax.grad``
    gives).  ``batch`` is a dict of arrays or tensors."""
    leaves = L.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.train_loss(params, shard_batch(batch, model.device),
                                remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), list(grads)


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """The train step: (state, batch) → (state, metrics), the state
    updated in place.  ``batch`` is a dict of arrays or tensors with the
    batch on the leading axis (numpy is moved to the model's device); the
    metrics are 0-d float32 tensors on the device."""

    def grads_of(params, batch):
        loss, grads = loss_and_grads(model, params, batch, tcfg.remat_policy)
        return loss, [torch.zeros_like(p) if g is None else g
                      for p, g in zip(L.tree_leaves(params), grads)]

    def train_step(state, batch):
        batch = shard_batch(batch, model.device)
        params = state["params"]
        k = tcfg.microbatches
        if k > 1:
            split = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                     for n, x in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in L.tree_leaves(params)]
            losses = []
            for i in range(k):
                loss, g = grads_of(
                    params, {n: x[i] for n, x in split.items()})
                losses.append(loss)
                for a, gi in zip(acc, g):
                    a.add_(gi / k)
            grads = acc
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grads_of(params, batch)

        lr_scale = schedule.warmup_cosine(state["opt"]["step"],
                                          tcfg.warmup_steps, tcfg.total_steps)
        with torch.profiler.record_function("adamw.update"):
            params, opt, metrics = adamw.update(
                grads, state["opt"], params, tcfg.optimizer, lr_scale)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


class TrainLoop:
    """Fault-tolerant loop: restart-exact resume, async ckpt, stragglers."""

    def __init__(self, model, source, train_step, tcfg: TrainConfig,
                 ckpt_dir: str, init_fn: Callable[[], Any],
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.model = model
        self.source = source
        self.train_step = train_step
        self.tcfg = tcfg
        self.ckpt_dir = ckpt_dir
        self.init_fn = init_fn
        self.failure_injector = failure_injector
        self.saver = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=tcfg.ckpt_keep)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.restarts = 0
        self.history: list[dict] = []

    def _load_or_init(self):
        last = ckpt_lib.latest_step(self.ckpt_dir)
        if last is not None:
            template = init_state(self.model, device="meta")
            state, _ = ckpt_lib.restore(self.ckpt_dir, template, last,
                                        device=self.model.device)
            log.info("restored step %d", last)
            return state, last + 1
        return self.init_fn(), 0

    def run(self, steps: int):
        state, start = self._load_or_init()
        step = start
        while step < steps:
            try:
                t0 = time.monotonic()
                if self.failure_injector is not None:
                    self.failure_injector(step)
                batch = self.source.batch(step)
                state, metrics = self.train_step(state, batch)
                values = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                self._watch(step, dt)
                self.history.append({"step": step, **values})
                if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == steps:
                    self.saver.save(step, state)
                step += 1
            except (ckpt_lib.json.JSONDecodeError, OSError):
                raise
            except RuntimeError as e:       # injected / device failure
                self.restarts += 1
                log.warning("step %d failed (%s); restart %d", step, e,
                            self.restarts)
                if self.restarts > self.tcfg.max_restarts:
                    raise
                self.saver.wait()
                state, step = self._load_or_init()
        self.saver.wait()
        return state

    def _watch(self, step: int, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if dt > self.tcfg.straggler_factor * med:
                self.stragglers.append(step)
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)
