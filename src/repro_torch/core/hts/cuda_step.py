"""The population step's four kernel phases: CUDA kernels and plain versions.

Counterpart of the reference's ``pallas_step.py``.  The reference runs
four phases of its population step as lane-per-program Pallas kernels
(``machine.make_pop_step``: ``k_enqueue``, ``k_grant``, ``k_issue``,
``k_traces``).  Here each is a hand-written CUDA kernel for Hopper
(``csrc/hts_step.cu``, one CTA per lane), with:

* a wrapper (:func:`enqueue`, :func:`grant`, :func:`issue`,
  :func:`traces`) that checks device, dtype, shape and contiguity, launches
  the kernel for CUDA tensors, and hands CPU tensors to the plain version —
  nothing else falls back;
* a plain lane-batched torch version (``*_ref``) with the same outputs,
  which the CPU runs and which ``chip_smoke.py`` holds each kernel against;
* a launch counter (:data:`launches`), raised only where a kernel launches.

Every phase updates the state dict's tensors **in place** (the kernels
write the lanes' rows where they lie; the plain versions ``copy_`` into the
same tensors), and writes exactly the keys its reference kernel returns:
:data:`ENQ_KEYS`, :data:`GRANT_KEYS` plus ``br_ready``, :data:`ISSUE_KEYS`,
:data:`TRACE_KEYS`.

The library is built at first use with ``nvcc`` (``-gencode
arch=compute_90a,code=sm_90a``) into ``build/repro_torch/`` at the root of
the checkout and loaded with ``ctypes`` (:mod:`repro_torch._build`);
nothing is compiled at import.
"""
from __future__ import annotations

import torch

from ... import _build
from .costs import NUM_FUNCS
from .isa import BR_BR
from .policy import AGE_SPAN, NUM_PIDS, PRIO_CAP

I32 = torch.int32
BOOL = torch.bool
BIG = 2**30

ENQ_KEYS = ("cdb_valid", "cdb_uid", "cdb_ticket", "cdb_ready", "cdb_spec",
            "ticket", "overflow", "tr_complete", "fu_busy", "fu_uid")
GRANT_KEYS = ("cdb_valid", "rs_dep", "trk_valid", "tr_broadcast")
ISSUE_KEYS = ("fu_busy", "fu_uid", "fu_rem", "fu_out_s", "fu_out_e",
              "fu_src", "fu_spec", "fu_pid", "tr_issue", "rs_valid")
TRACE_KEYS = ("tr_func", "tr_dispatch", "tr_dep", "tr_pid", "tr_aborted")

# ---------------------------------------------------------------------------
# build + load (the port's one nvcc + ctypes route, ``repro_torch._build``)
# ---------------------------------------------------------------------------
_P, _I = _build.P, _build.I
#: ``csrc/hts_step.cu``: ``LIB.build()`` compiles it, ``LIB.info`` holds the
#: last build's report (seconds, command, ptxas's -Xptxas -v)
LIB = _build.Library("hts_step.cu", {
    # sizes..., pointers..., stream
    "hts_enqueue": [_I] * 5 + [_P] * 13 + [_P],
    "hts_grant": [_I] * 6 + [_P] * 14 + [_P],
    "hts_issue": [_I] * 7 + [_P] * 27 + [_P],
    "hts_traces": [_I] * 4 + [_P] * 15 + [_P],
}, ("enqueue", "grant", "issue", "traces"))
SOURCE, BUILD_DIR = LIB.source, _build.BUILD_DIR
#: kernel launches per wrapper (plain-version calls are not counted)
launches, reset_launches = LIB.launches, LIB.reset_launches


def _check(n: int, dev: torch.device, items) -> None:
    """Each item is (name, tensor, dtype, shape without the lane axis)."""
    for name, t, dtype, shape in items:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != (n,) + tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(n,) + tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


# ---------------------------------------------------------------------------
# shared plain-torch pieces
# ---------------------------------------------------------------------------
def _col(x):
    return x[:, None]


def _gather(arr, idx):
    """JAX gather: a negative index wraps once, then clamps into range."""
    n = arr.shape[1]
    return arr.gather(1, torch.where(idx < 0, idx + n, idx)
                      .clamp(0, n - 1).long())


def _scatter_drop(arr, idx, value, enable) -> None:
    """``arr[lane, idx] = value where enable``, in place, with JAX's
    ``mode="drop"``: a negative index wraps once, and an index still outside
    ``[0, U)`` writes nothing (the machine uses ``U`` as "no write")."""
    U = arr.shape[1]
    if idx.dim() == 1:
        idx, enable = idx[:, None], enable[:, None]
    value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    if value.dim() == 1:
        value = value[:, None]
    value = value.expand(idx.shape)
    idx = torch.where(idx < 0, idx + U, idx)
    ok = enable & (idx >= 0) & (idx < U)
    lanes = torch.arange(arr.shape[0], device=arr.device)[:, None]
    arr[lanes.expand(idx.shape)[ok], idx[ok].long()] = value[ok]


# ---------------------------------------------------------------------------
# K1: CDB enqueue (reference machine.py cdb_enqueue, kernel k_enqueue)
# ---------------------------------------------------------------------------
def _enqueue_shapes(st, done):
    n, C = st["cdb_valid"].shape
    NFU, U = done.shape[1], st["tr_complete"].shape[1]
    items = [("done", done, BOOL, (NFU,))]
    for k in ("cdb_valid", "cdb_spec"):
        items.append((k, st[k], BOOL, (C,)))
    for k in ("cdb_uid", "cdb_ticket", "cdb_ready"):
        items.append((k, st[k], I32, (C,)))
    items += [("ticket", st["ticket"], I32, ()),
              ("overflow", st["overflow"], BOOL, ()),
              ("cycle", st["cycle"], I32, ()),
              ("tr_complete", st["tr_complete"], I32, (U,)),
              ("fu_busy", st["fu_busy"], BOOL, (NFU,)),
              ("fu_uid", st["fu_uid"], I32, (NFU,)),
              ("fu_spec", st["fu_spec"], BOOL, (NFU,))]
    return n, C, NFU, U, items


def enqueue(st: dict, done: torch.Tensor, completion_extra: int) -> None:
    """K1, in place on :data:`ENQ_KEYS`: the k-th done unit (FU-index
    order) takes the k-th free CDB slot and ticket ``ticket + k``."""
    n, C, NFU, U, items = _enqueue_shapes(st, done)
    dev = done.device
    _check(n, dev, items)
    if not _build.on_card(dev):
        return enqueue_ref(st, done, completion_extra)
    LIB.launch("hts_enqueue", "enqueue", n, C, NFU, U, completion_extra,
               done, st["cdb_valid"], st["cdb_uid"], st["cdb_ticket"],
               st["cdb_ready"], st["cdb_spec"], st["ticket"], st["overflow"],
               st["cycle"], st["tr_complete"], st["fu_busy"], st["fu_uid"],
               st["fu_spec"])


def enqueue_ref(st: dict, done: torch.Tensor, completion_extra: int) -> None:
    """Plain K1: the reference's cumsum/searchsorted form, lane-batched."""
    NFU = done.shape[1]
    n_done = done.sum(1, dtype=I32)
    free = ~st["cdb_valid"]
    free_rank = free.cumsum(1, dtype=I32) - 1                # slot rank
    n_free = free.sum(1, dtype=I32)
    n_enq = torch.minimum(n_done, n_free)
    fr = free_rank.clamp(0, NFU - 1)
    # csum[i] counts completions through unit i, so the first index with
    # csum ≥ r+1 is the r-th completing unit (searchsorted side="left")
    csum = done.cumsum(1, dtype=I32)
    u = torch.searchsorted(csum, fr + 1).clamp(0, NFU - 1)
    take = free & (free_rank < _col(n_enq))
    cycle = st["cycle"]
    st["cdb_uid"].copy_(torch.where(take, st["fu_uid"].gather(1, u),
                                    st["cdb_uid"]))
    st["cdb_ticket"].copy_(torch.where(take, _col(st["ticket"]) + free_rank,
                                       st["cdb_ticket"]))
    st["cdb_ready"].copy_(torch.where(take, _col(cycle + completion_extra),
                                      st["cdb_ready"]))
    st["cdb_spec"].copy_(torch.where(take, st["fu_spec"].gather(1, u),
                                     st["cdb_spec"]))
    st["cdb_valid"].copy_(st["cdb_valid"] | take)
    st["ticket"].copy_(st["ticket"] + n_enq)
    st["overflow"].copy_(st["overflow"] | (n_done > n_free))
    # trace + unit release
    _scatter_drop(st["tr_complete"], st["fu_uid"], cycle, done)
    st["fu_busy"].copy_(st["fu_busy"] & ~done)
    st["fu_uid"].copy_(torch.where(done, 0, st["fu_uid"]))


# ---------------------------------------------------------------------------
# K2: CDB grant (reference cdb_grant(unroll=True), kernel k_grant)
# ---------------------------------------------------------------------------
def _grant_shapes(st, br_ready, alive):
    n, C = st["cdb_valid"].shape
    S, T = st["rs_dep"].shape[1], st["trk_valid"].shape[1]
    U = st["tr_broadcast"].shape[1]
    items = [("cdb_valid", st["cdb_valid"], BOOL, (C,))]
    for k in ("cdb_ready", "cdb_ticket", "cdb_uid"):
        items.append((k, st[k], I32, (C,)))
    items += [("cycle", st["cycle"], I32, ()),
              ("alive", alive, BOOL, ()),
              ("rs_dep", st["rs_dep"], I32, (S,)),
              ("trk_valid", st["trk_valid"], BOOL, (T,)),
              ("trk_uid", st["trk_uid"], I32, (T,)),
              ("tr_broadcast", st["tr_broadcast"], I32, (U,)),
              ("br_active", st["br_active"], BOOL, ()),
              ("br_kind", st["br_kind"], I32, ()),
              ("br_wait", st["br_wait"], I32, ()),
              ("br_ready", br_ready, BOOL, ())]
    return n, C, S, T, U, items


def grant(st: dict, br_ready: torch.Tensor, alive: torch.Tensor,
          cdb_width: int) -> None:
    """K2, in place on :data:`GRANT_KEYS` and ``br_ready``: ``cdb_width``
    broadcasts, each of the ready entry with the smallest ticket."""
    n, C, S, T, U, items = _grant_shapes(st, br_ready, alive)
    dev = alive.device
    _check(n, dev, items)
    if not _build.on_card(dev):
        return grant_ref(st, br_ready, alive, cdb_width)
    LIB.launch("hts_grant", "grant", n, C, S, T, U, cdb_width,
               st["cdb_valid"], st["cdb_ready"], st["cdb_ticket"],
               st["cdb_uid"], st["cycle"], alive, st["rs_dep"],
               st["trk_valid"], st["trk_uid"], st["tr_broadcast"],
               st["br_active"], st["br_kind"], st["br_wait"], br_ready)


def grant_ref(st: dict, br_ready: torch.Tensor, alive: torch.Tensor,
              cdb_width: int) -> None:
    """Plain K2: ``cdb_width`` unrolled grants, lane-batched."""
    C = st["cdb_valid"].shape[1]
    c_iota = torch.arange(C, device=alive.device)
    cycle = st["cycle"]
    for _ in range(cdb_width):
        ready = (st["cdb_valid"] & (st["cdb_ready"] <= _col(cycle))
                 & _col(alive))
        idx = torch.where(ready, st["cdb_ticket"], BIG).argmin(1)
        has = ready.any(1)
        uid = st["cdb_uid"].gather(1, idx[:, None])[:, 0]
        st["cdb_valid"].copy_(st["cdb_valid"]
                              & ~(_col(has) & (c_iota == idx[:, None])))
        st["rs_dep"].copy_(torch.where(_col(has) & (st["rs_dep"] == _col(uid)),
                                       0, st["rs_dep"]))
        st["trk_valid"].copy_(st["trk_valid"]
                              & ~(_col(has) & (st["trk_uid"] == _col(uid))))
        _scatter_drop(st["tr_broadcast"], uid, cycle, has)
        br_ready.copy_(br_ready | (has & st["br_active"]
                                   & (st["br_kind"] == BR_BR)
                                   & (st["br_wait"] == uid)))


# ---------------------------------------------------------------------------
# K3: RS issue (reference rs_issue_fast + _issue_apply, kernel k_issue)
# ---------------------------------------------------------------------------
_RS_INT = ("rs_dep", "rs_pid", "rs_age", "rs_func", "rs_uid", "rs_exec",
           "rs_out_s", "rs_out_e", "rs_src")
_FU_INT = ("fu_uid", "fu_rem", "fu_out_s", "fu_out_e", "fu_src", "fu_pid")


def _issue_shapes(st, exists, prio, quota, cost, eft, alive):
    n, S = st["rs_valid"].shape
    NFU, U = st["fu_busy"].shape[1], st["tr_issue"].shape[1]
    items = [("rs_valid", st["rs_valid"], BOOL, (S,)),
             ("rs_spec", st["rs_spec"], BOOL, (S,)),
             ("fu_busy", st["fu_busy"], BOOL, (NFU,)),
             ("fu_spec", st["fu_spec"], BOOL, (NFU,)),
             ("tr_issue", st["tr_issue"], I32, (U,)),
             ("cycle", st["cycle"], I32, ()),
             ("exists", exists, BOOL, (NFU,)),
             ("prio", prio, I32, (NUM_PIDS,)),
             ("quota", quota, I32, (NUM_PIDS,)),
             ("cost", cost, I32, (NFU,)),
             ("eft", eft, I32, ()),
             ("alive", alive, BOOL, ())]
    items += [(k, st[k], I32, (S,)) for k in _RS_INT]
    items += [(k, st[k], I32, (NFU,)) for k in _FU_INT]
    if NFU % NUM_FUNCS:
        raise ValueError(f"{NFU} units is not {NUM_FUNCS} equal classes")
    return n, S, NFU, U, items


def issue(st: dict, exists, prio, quota, cost, eft, alive,
          issue_width: int) -> None:
    """K3, in place on :data:`ISSUE_KEYS`: the weighted RS arbiter."""
    n, S, NFU, U, items = _issue_shapes(st, exists, prio, quota, cost, eft,
                                        alive)
    dev = alive.device
    _check(n, dev, items)
    if not _build.on_card(dev):
        return issue_ref(st, exists, prio, quota, cost, eft, alive,
                         issue_width)
    LIB.launch("hts_issue", "issue", n, S, NUM_FUNCS, NFU // NUM_FUNCS, U,
               NUM_PIDS, issue_width,
               st["rs_valid"], st["rs_dep"], st["rs_pid"], st["rs_age"],
               st["rs_func"], st["rs_uid"], st["rs_exec"], st["rs_out_s"],
               st["rs_out_e"], st["rs_src"], st["rs_spec"],
               st["fu_busy"], st["fu_uid"], st["fu_rem"], st["fu_out_s"],
               st["fu_out_e"], st["fu_src"], st["fu_spec"], st["fu_pid"],
               st["tr_issue"], st["cycle"], exists, prio, quota, cost, eft,
               alive)


def issue_ref(st: dict, exists, prio, quota, cost, eft, alive,
              issue_width: int) -> None:
    """Plain K3.  The issue key is unique among ready entries and BIG on
    the rest, so "rank within subset X" is ``key_lt`` with X's columns."""
    n, S = st["rs_valid"].shape
    NFU = st["fu_busy"].shape[1]
    Wc = NFU // NUM_FUNCS
    dev = alive.device
    fu_cls = torch.arange(NUM_FUNCS, device=dev).repeat_interleave(Wc)
    rs_func, rs_pid = st["rs_func"], st["rs_pid"]
    ready = st["rs_valid"] & (st["rs_dep"] == 0) & _col(alive)
    free = exists & ~st["fu_busy"]
    n_free = free.view(n, NUM_FUNCS, Wc).sum(2, dtype=I32)
    w = _gather(prio, rs_pid).clamp(0, PRIO_CAP)
    key = torch.where(ready, (PRIO_CAP - w) * AGE_SPAN + st["rs_age"], BIG)
    key_lt = key[:, None, :] < key[:, :, None]       # [lane, e, j]: j ahead
    same_cls = rs_func[:, :, None] == rs_func[:, None, :]
    same_pid = rs_pid[:, :, None] == rs_pid[:, None, :]
    busy = st["fu_busy"] & exists
    inflight = (busy[:, None, :] & (st["fu_pid"][:, None, :]
                                    == rs_pid[:, :, None])
                & (fu_cls == rs_func[:, :, None])).sum(2, dtype=I32)
    q_rank = (key_lt & same_cls & same_pid
              & ready[:, None, :]).sum(2, dtype=I32)
    eligible = ready & (inflight + q_rank < _gather(quota, rs_pid))
    cls_rank = (key_lt & same_cls & eligible[:, None, :]).sum(2, dtype=I32)
    issuable = eligible & (cls_rank < _gather(n_free, rs_func))
    g_rank = (key_lt & issuable[:, None, :]).sum(2, dtype=I32)
    fire = issuable & (g_rank < issue_width)
    f_rank = (key_lt & same_cls & fire[:, None, :]).sum(2, dtype=I32)
    # per-class unit ranking by ckey: FU index (greedy) or cost-major (eft)
    ckey = (torch.where(_col(eft) != 0, cost, 0) * NFU
            + torch.arange(NFU, dtype=I32, device=dev)).view(n, NUM_FUNCS, Wc)
    free_c = free.view(n, NUM_FUNCS, Wc)
    unit_rank = (free_c[:, :, None, :] & (ckey[:, :, None, :]
                                          < ckey[:, :, :, None])
                 ).sum(3, dtype=I32).view(n, NFU)
    m = (fire[:, :, None] & free[:, None, :]
         & (rs_func[:, :, None] == fu_cls)
         & (f_rank[:, :, None] == unit_rank[:, None, :]))     # entry → unit
    eou = m.to(I32).argmax(1)                         # first entry per unit
    hit = m.any(1)
    st["fu_busy"].copy_(st["fu_busy"] | hit)
    for fk, rk in (("fu_uid", "rs_uid"), ("fu_out_s", "rs_out_s"),
                   ("fu_out_e", "rs_out_e"), ("fu_src", "rs_src"),
                   ("fu_spec", "rs_spec"), ("fu_pid", "rs_pid")):
        st[fk].copy_(torch.where(hit, st[rk].gather(1, eou), st[fk]))
    st["fu_rem"].copy_(torch.where(hit, st["rs_exec"].gather(1, eou) * cost,
                                   st["fu_rem"]))
    _scatter_drop(st["tr_issue"], st["rs_uid"], st["cycle"], fire)
    st["rs_valid"].copy_(st["rs_valid"] & ~fire)


# ---------------------------------------------------------------------------
# K4: abort + dispatch traces (reference abort_traces + dispatch traces,
# kernel k_traces)
# ---------------------------------------------------------------------------
def _traces_shapes(st, rs_uid_k, rs_kill, fu_uid_k, fu_kill, uid, acc, dep,
                   pid, dispatch):
    n, U = st["tr_func"].shape
    S, NFU = rs_uid_k.shape[1], fu_uid_k.shape[1]
    items = [(k, st[k], I32, (U,)) for k in ("tr_func", "tr_dispatch",
                                             "tr_dep", "tr_pid")]
    items += [("tr_aborted", st["tr_aborted"], BOOL, (U,)),
              ("rs_uid_k", rs_uid_k, I32, (S,)),
              ("rs_kill", rs_kill, BOOL, (S,)),
              ("fu_uid_k", fu_uid_k, I32, (NFU,)),
              ("fu_kill", fu_kill, BOOL, (NFU,)),
              ("uid", uid, I32, ()), ("acc", acc, I32, ()),
              ("dep", dep, I32, ()), ("pid", pid, I32, ()),
              ("dispatch", dispatch, BOOL, ()),
              ("cycle", st["cycle"], I32, ())]
    return n, S, NFU, U, items


def traces(st: dict, rs_uid_k, rs_kill, fu_uid_k, fu_kill, uid, acc, dep,
           pid, dispatch) -> None:
    """K4, in place on :data:`TRACE_KEYS`: ``tr_aborted`` for killed RS
    entries and units, then the four dispatch traces at ``uid``."""
    n, S, NFU, U, items = _traces_shapes(st, rs_uid_k, rs_kill, fu_uid_k,
                                         fu_kill, uid, acc, dep, pid,
                                         dispatch)
    dev = dispatch.device
    _check(n, dev, items)
    if not _build.on_card(dev):
        return traces_ref(st, rs_uid_k, rs_kill, fu_uid_k, fu_kill, uid,
                          acc, dep, pid, dispatch)
    LIB.launch("hts_traces", "traces", n, S, NFU, U,
               st["tr_aborted"], st["tr_func"], st["tr_dispatch"],
               st["tr_dep"], st["tr_pid"], rs_uid_k, rs_kill, fu_uid_k,
               fu_kill, uid, acc, dep, pid, dispatch, st["cycle"])


def traces_ref(st: dict, rs_uid_k, rs_kill, fu_uid_k, fu_kill, uid, acc,
               dep, pid, dispatch) -> None:
    """Plain K4."""
    _scatter_drop(st["tr_aborted"], rs_uid_k, True, rs_kill)
    _scatter_drop(st["tr_aborted"], fu_uid_k, True, fu_kill)
    for k, v in (("tr_func", acc), ("tr_dispatch", st["cycle"]),
                 ("tr_dep", dep), ("tr_pid", pid)):
        _scatter_drop(st[k], uid, v, dispatch)


#: every kernel phase by counter name: (wrapper, plain version, keys it writes)
KERNELS = {
    "enqueue": (enqueue, enqueue_ref, ENQ_KEYS),
    "grant": (grant, grant_ref, GRANT_KEYS),
    "issue": (issue, issue_ref, ISSUE_KEYS),
    "traces": (traces, traces_ref, TRACE_KEYS),
}
