"""Scheduling policy: per-pid priority weights and per-pid FU quotas.

The paper's multi-application sharing story gives every tenant equal
standing: the reservation station issues strictly in *age* order, so a
greedy tenant that keeps the RS full can starve a latency-sensitive one
(``Result.fairness`` measures exactly this).  Priority-aware scheduling
for heterogeneous accelerator pools (Chen & Marculescu 2017) and the
hardware-HEFT scheduler of Fusco et al. 2022 both recover QoS with cheap
priority/quota logic in the arbiter; :class:`SchedPolicy` is that logic's
configuration:

* **weights** — per-pid priority weight.  The RS arbiter issues
  priority-class first (higher weight wins), age order *within* a class;
  all-equal weights degrade to the paper's pure age order bit-for-bit.
* **quotas** — optional per-pid cap on *in-flight accelerator units per
  function class*.  A pid at its cap is masked out of the per-class
  free-unit ranking until one of its tasks completes; the freed unit
  falls to the next eligible entry (the arbiter stays work-conserving).
* **rs_caps** — optional per-pid cap on *reservation-station entries*
  (admission control).  FU quotas gate only execution occupancy: a
  greedy tenant can still fill the whole RS with pending entries and
  dispatch-block every later tenant behind a structural stall.  An RS
  cap stalls *that pid's own* task dispatch once its RS occupancy
  reaches the cap (exactly like the RS-full structural stall, but per
  pid), so floods capped below ``rs_entries`` can never exhaust the
  shared window — the headroom is effectively reserved for uncapped
  tenants, mirroring how FU quotas below the pool size reserve units.

A policy is **data, not configuration**: the machine receives the
weight/quota arrays as runtime arguments (like ``n_fu``), one row per
lane of a population.  The golden oracle implements the identical arbitration
sequentially; ``hts.compare`` proves the two agree on every scenario.

>>> pol = SchedPolicy.of(weights={1: 8}, quotas={2: 1})
>>> pol.weight_of(1), pol.weight_of(2), pol.quota_of(2)
(8, 0, 1)
>>> int(pol.weight_array()[1])
8
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

#: pid is a 4-bit ISA field (Table I) — 16 addressable processes.
NUM_PIDS = 16
#: weights are clipped to [0, PRIO_CAP] so the combined issue key
#: ``(PRIO_CAP - weight) * AGE_SPAN + age`` stays an exact int32.
PRIO_CAP = 1 << 12
#: must exceed any task age (age increments once per dispatched task and
#: is bounded by ``HtsParams.max_tasks``).
AGE_SPAN = 1 << 17
#: quota value meaning "uncapped" (larger than any possible in-flight count).
NO_QUOTA = 1 << 30


@dataclasses.dataclass(frozen=True)
class SchedPolicy:
    """Per-pid scheduling policy (hashable: safe inside ``HtsParams``).

    Use :meth:`of` to build one from plain dicts; the stored form is
    sorted ``(pid, value)`` tuples so two policies with the same content
    hash and compare equal.
    """
    weights: tuple[tuple[int, int], ...] = ()   # (pid, priority weight)
    quotas: tuple[tuple[int, int], ...] = ()    # (pid, max in-flight/class)
    rs_caps: tuple[tuple[int, int], ...] = ()   # (pid, max RS entries)
    default_weight: int = 0
    #: frontend arbitration between per-tenant dispatch streams
    #: (``core/hts/frontend.py``): ``"rr"`` = round-robin over eligible
    #: streams (the default — all tenants equal at dispatch), ``"weighted"``
    #: = a stream's pid priority weight ranks first, round-robin within a
    #: weight class.  Irrelevant to single-stream (merged) programs.
    fe_mode: str = "rr"
    #: RS unit-selection rule once an entry wins arbitration: ``"greedy"``
    #: grants the lowest-indexed free unit of the class (the paper's
    #: machine — all units identical, so index order is finish order);
    #: ``"eft"`` grants the free unit with the earliest predicted finish
    #: time under the per-(class, unit) cost tables (``fu_cost``) — only
    #: *free* units are candidates, so the busy-horizon term is zero and
    #: EFT ranks by cost-table latency, ties broken by unit index.  With
    #: uniform costs the two are bit-identical.  Like the weight/quota
    #: arrays this is traced runtime data: flipping modes never recompiles.
    issue_mode: str = "greedy"

    @staticmethod
    def _norm_fe_mode(fe_mode: str) -> str:
        if fe_mode not in ("rr", "weighted"):
            raise ValueError(f'fe_mode must be "rr" or "weighted", '
                             f'got {fe_mode!r}')
        return fe_mode

    @staticmethod
    def _norm_issue_mode(issue_mode: str) -> str:
        if issue_mode not in ("greedy", "eft"):
            raise ValueError(f'issue_mode must be "greedy" or "eft", '
                             f'got {issue_mode!r}')
        return issue_mode

    @classmethod
    def of(cls, weights: Optional[Mapping[int, int]] = None,
           quotas: Optional[Mapping[int, int]] = None,
           rs_caps: Optional[Mapping[int, int]] = None,
           default_weight: int = 0, fe_mode: str = "rr",
           issue_mode: str = "greedy") -> "SchedPolicy":
        """Build a policy from ``{pid: weight}`` / ``{pid: quota}`` /
        ``{pid: rs_cap}`` dicts."""
        def norm(m, what, lo, hi):
            items = []
            for pid, v in sorted((m or {}).items()):
                if not 0 <= int(pid) < NUM_PIDS:
                    raise ValueError(f"pid {pid} outside the 4-bit ISA "
                                     f"field [0, {NUM_PIDS})")
                if not lo <= int(v) <= hi:
                    raise ValueError(f"{what} for pid {pid} must be in "
                                     f"[{lo}, {hi}], got {v}")
                items.append((int(pid), int(v)))
            return tuple(items)
        if not 0 <= int(default_weight) <= PRIO_CAP:
            raise ValueError(f"default_weight must be in [0, {PRIO_CAP}], "
                             f"got {default_weight}")
        return cls(weights=norm(weights, "weight", 0, PRIO_CAP),
                   quotas=norm(quotas, "quota", 1, NO_QUOTA),
                   rs_caps=norm(rs_caps, "rs_cap", 1, NO_QUOTA),
                   default_weight=int(default_weight),
                   fe_mode=cls._norm_fe_mode(fe_mode),
                   issue_mode=cls._norm_issue_mode(issue_mode))

    # ----------------------------------------------------------- lookups
    def weight_of(self, pid: int) -> int:
        return dict(self.weights).get(pid, self.default_weight)

    def quota_of(self, pid: int) -> int:
        """Per-class in-flight cap for ``pid`` (``NO_QUOTA`` if uncapped)."""
        return dict(self.quotas).get(pid, NO_QUOTA)

    def rs_cap_of(self, pid: int) -> int:
        """Max RS entries ``pid`` may hold at once (``NO_QUOTA`` = uncapped)."""
        return dict(self.rs_caps).get(pid, NO_QUOTA)

    @property
    def is_default(self) -> bool:
        """True iff this policy degrades to pure age-order arbitration."""
        return (not self.quotas and not self.rs_caps
                and self.issue_mode == "greedy"
                and all(w == self.default_weight for _, w in self.weights))

    # ------------------------------------------------------ array forms
    def weight_array(self, num_pids: int = NUM_PIDS) -> np.ndarray:
        """(num_pids,) int32 weight table (clipped to [0, PRIO_CAP])."""
        arr = np.full((num_pids,), self.default_weight, np.int32)
        for pid, w in self.weights:
            arr[pid] = w
        return np.clip(arr, 0, PRIO_CAP)

    def quota_array(self, num_pids: int = NUM_PIDS) -> np.ndarray:
        """(num_pids,) int32 per-class in-flight caps (NO_QUOTA = uncapped)."""
        arr = np.full((num_pids,), NO_QUOTA, np.int32)
        for pid, q in self.quotas:
            arr[pid] = q
        return arr

    def rs_cap_array(self, num_pids: int = NUM_PIDS) -> np.ndarray:
        """(num_pids,) int32 RS-entry admission caps (NO_QUOTA = uncapped)."""
        arr = np.full((num_pids,), NO_QUOTA, np.int32)
        for pid, q in self.rs_caps:
            arr[pid] = q
        return arr

    # --------------------------------------------------------- utilities
    def merge_with(self, other: "SchedPolicy") -> "SchedPolicy":
        """Union of two policies; conflicting entries for a pid are an error
        (used by :meth:`builder.Program.merge` to combine tenant policies)."""
        if other.default_weight != self.default_weight:
            raise ValueError("cannot merge policies with different "
                             "default weights")
        if other.fe_mode != self.fe_mode:
            raise ValueError("cannot merge policies with different "
                             "frontend modes "
                             f"({self.fe_mode!r} vs {other.fe_mode!r})")
        if other.issue_mode != self.issue_mode:
            raise ValueError("cannot merge policies with different "
                             "issue modes "
                             f"({self.issue_mode!r} vs {other.issue_mode!r})")
        out_w, out_q = dict(self.weights), dict(self.quotas)
        out_r = dict(self.rs_caps)
        for src, dst, what in ((other.weights, out_w, "weight"),
                               (other.quotas, out_q, "quota"),
                               (other.rs_caps, out_r, "rs_cap")):
            for pid, v in src:
                if pid in dst and dst[pid] != v:
                    raise ValueError(f"conflicting {what} for pid {pid}: "
                                     f"{dst[pid]} vs {v}")
                dst[pid] = v
        return SchedPolicy.of(out_w, out_q, out_r, self.default_weight,
                              self.fe_mode, self.issue_mode)

    def issue_key(self, pid: int, age: int) -> int:
        """The arbiter's scalar sort key: priority class first (higher
        weight = smaller key), age order within a class.  Both simulators
        order RS entries by exactly this value."""
        w = min(max(self.weight_of(pid), 0), PRIO_CAP)
        return (PRIO_CAP - w) * AGE_SPAN + age

    def describe(self) -> str:
        if self.is_default:
            return "age-order (no priorities, no quotas)"
        parts = []
        if self.weights:
            parts.append("weights " + ",".join(f"{p}:{w}"
                                               for p, w in self.weights))
        if self.quotas:
            parts.append("quotas " + ",".join(f"{p}:{q}"
                                              for p, q in self.quotas))
        if self.rs_caps:
            parts.append("rs_caps " + ",".join(f"{p}:{q}"
                                               for p, q in self.rs_caps))
        if self.fe_mode != "rr":
            parts.append(f"frontends {self.fe_mode}")
        if self.issue_mode != "greedy":
            parts.append(f"issue {self.issue_mode}")
        return "; ".join(parts)
