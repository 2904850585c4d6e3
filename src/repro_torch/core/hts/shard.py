"""Scenario-axis sharding: one :class:`~repro_torch.core.hts.batch.PackedPopulation`
across CUDA devices.

The scenario axis is embarrassingly parallel (every lane of a packed
population is an independent machine), so sharding it is data placement:
split the 11 machine arguments and the carry into ``devices`` contiguous
lane shards, one :class:`~repro_torch.core.hts.machine.Machine` on
``cuda:i`` for shard ``i``, and merge the results back in lane order.
Each card runs ``hts_run`` on its own lanes, so a shard drains as fast as
its slowest lane, not the whole population's.

* :func:`pad_lanes` pads the lane count to a multiple of the device count
  by replicating the population's lightest lane (smallest ``p_len``: pad
  lanes halt early and stay fixed points).  Real lanes keep their
  indices; callers drop the tail.
* :func:`sharded_runner` is one :class:`ShardedMachine` per ``(spec,
  max_prog, devices, device)``: ``init``, ``run_slice``, ``collect`` and
  ``run`` with :class:`~repro_torch.core.hts.machine.Machine`'s meaning,
  the carry a list of per-shard carries.
* :func:`advance` steps a list of carries, each on its own device: every
  ``hts_run`` launch is issued (under ``torch.cuda.device(i)``, since a
  launch takes the current device's stream) before anything is read
  back, so the cards run at once.

``api.run_many(devices=N)`` and ``api.compare_population(devices=N)`` are
the front doors, ``ServeSpec(devices=N)`` the server's.  On the card,
``devices`` must lie in ``1..device_count()``.  With ``device="cpu"`` the N
shards run one after another on the CPU, which shows the split, the
padding and the merge where there is no card.

The reference's ``core/compat.py`` (the ``jax.shard_map`` spelling shim
its sharded machines go through) has no torch counterpart: a torch shard
is a plain machine on its own device, and nothing is traced.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ... import _build
from . import cuda_run, machine
from .batch import PackedPopulation


def device_count() -> int:
    """CUDA devices visible to this process (the ``devices=`` upper bound
    on the card)."""
    return torch.cuda.device_count()


def pad_lanes(pop: PackedPopulation, multiple: int) -> PackedPopulation:
    """Pad ``pop`` to a lane count divisible by ``multiple``.

    Pad lanes replicate the lightest real lane (smallest ``p_len``), so
    they halt first and idle as fixed points while their shard's real
    lanes finish.  Real lanes keep indices ``0..len(pop)-1``; callers slice
    the results back to that prefix.
    """
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    n = len(pop)
    total = -(-n // multiple) * multiple
    if total == n:
        return pop
    src = int(np.argmin(pop.p_len))
    k = total - n

    def rep(a: np.ndarray) -> np.ndarray:
        return np.concatenate([a, np.repeat(a[src:src + 1], k, axis=0)],
                              axis=0)

    return dataclasses.replace(
        pop,
        names=pop.names + (f"<pad:{pop.names[src]}>",) * k,
        preps=pop.preps + (pop.preps[src],) * k,
        policies=pop.policies + (pop.policies[src],) * k,
        ftab=rep(pop.ftab), p_len=rep(pop.p_len),
        mem=rep(pop.mem), eff=rep(pop.eff), n_fu=rep(pop.n_fu),
        prio=rep(pop.prio), quota=rep(pop.quota), rs_cap=rep(pop.rs_cap),
        fu_cost=rep(pop.fu_cost), eft=rep(pop.eft),
        streams=rep(pop.streams))


def shard_devices(devices: int, device=None) -> tuple[torch.device, ...]:
    """The device of each of ``devices`` shards: ``cuda:0`` .. ``cuda:N-1``
    on the card (``ValueError`` past :func:`device_count`), the CPU N times
    for ``device="cpu"``."""
    dev = machine.resolve_device(device)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if dev.type == "cpu":
        return (dev,) * devices
    avail = device_count()
    if devices > avail:
        raise ValueError(f"devices={devices} requested but this process "
                         f"sees {avail} CUDA device(s)")
    return tuple(torch.device("cuda", i) for i in range(devices))


def advance(shards, budget: int, *, count_trips: bool = True) -> None:
    """Advance each ``(machine, carry, machine.Args)`` of ``shards`` in
    place by at most ``budget`` steps a lane, as ``machine._advance``
    does, each carry on its own device.  Every ``hts_run`` launch is issued
    before any read-back; the per-phase loop (a CPU carry, or a spec
    ``hts_run`` cannot hold) runs shard after shard.  ``count_trips=False``
    skips the launches' read-back of the steps they ran (the server reads
    back one thing a slice)."""
    started = []
    for m, st, a in shards:
        dev = st["cycle"].device
        if not _build.on_card(dev):
            machine._advance(m, st, a, budget)
            continue
        with torch.cuda.device(dev):
            if cuda_run.fits(m, a.streams.shape[1]):
                started.append((m, st, cuda_run.launch(m, st, a, budget)))
            else:
                machine._advance(m, st, a, budget)
    if count_trips:
        for m, st, steps0 in started:
            cuda_run.add_trips(m, st, steps0)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedMachine:
    """:class:`~repro_torch.core.hts.machine.Machine`'s resumable trio and
    ``run`` over contiguous lane shards, one machine a device.  The carry
    is a list of per-shard carries; lane counts must divide the shard
    count (:func:`pad_lanes`).  ``stats["trips"]`` adds up, over the calls,
    the largest number of steps any lane of any shard advanced."""
    machines: tuple[machine.Machine, ...]
    stats: dict = dataclasses.field(default_factory=lambda: {"trips": 0})

    def _parts(self, n: int) -> list[slice]:
        k = len(self.machines)
        if n % k:
            raise ValueError(f"{n} lanes do not divide over {k} devices "
                             "(pad them: shard.pad_lanes)")
        return [slice(i * (n // k), (i + 1) * (n // k)) for i in range(k)]

    def split_args(self, *args) -> list[machine.Args]:
        """The 11 machine arguments, normalised on each shard's device."""
        n = len(args[0])
        return [machine.norm_args(m, *(None if x is None else x[part]
                                       for x in args))
                for m, part in zip(self.machines, self._parts(n))]

    def init(self, *args) -> list[dict]:
        return [machine.init_state(m, a.mem_init, a.streams)
                for m, a in zip(self.machines, self.split_args(*args))]

    def _advance(self, carry: list, shards_args, budget: int) -> None:
        before = [m.stats["trips"] for m in self.machines]
        advance(list(zip(self.machines, carry, shards_args)), budget)
        self.stats["trips"] += max(
            m.stats["trips"] - b for m, b in zip(self.machines, before))

    def run_slice(self, carry: list, *args, budget: int) -> list[dict]:
        """Advance every alive lane by at most ``budget`` steps; the
        argument is left as it was (each shard's carry is copied first)."""
        st = [{k: v.clone() for k, v in c.items()} for c in carry]
        self._advance(st, self.split_args(*args), budget)
        return st

    def collect(self, carry: list) -> dict[str, torch.Tensor]:
        """The output dict, the shards merged in lane order on the CPU."""
        outs = [machine.collect(c) for c in carry]
        return {k: torch.cat([o[k].cpu() for o in outs]) for k in outs[0]}

    def run(self, *args) -> dict[str, torch.Tensor]:
        shards_args = self.split_args(*args)
        carry = [machine.init_state(m, a.mem_init, a.streams)
                 for m, a in zip(self.machines, shards_args)]
        self._advance(carry, shards_args, machine.BIG)
        return self.collect(carry)


@functools.lru_cache(maxsize=32)
def _sharded(spec: machine.MachineSpec, max_prog: int,
             devs: tuple[torch.device, ...]) -> ShardedMachine:
    return ShardedMachine(tuple(machine.make_machine(spec, max_prog, d)
                                for d in devs))


def sharded_runner(spec: machine.MachineSpec, max_prog: int, devices: int,
                   device=None) -> ShardedMachine:
    """The :class:`ShardedMachine` for one ``(spec, max_prog, devices,
    device)`` key, cached: every batch of a bucket gets the same object."""
    return _sharded(spec, max_prog, shard_devices(devices, device))
