"""The port's serving layer held against the JAX reference: the
continuous-batching ``Server``, ``greedy_decode``, ``speculative_decode``
and the ``launch.serve`` entry point.

Both packages run Qwen2-1.5B's smoke config (and for the ``Server``
also olmoe-1b-7b's, qwen2-moe-a2.7b's and paligemma-3b's) on the JAX
model's ``PRNGKey(0)`` parameters, carried with ``params_from_reference``,
in float32 (both ``COMPUTE_DTYPE``s set here): the outputs compared are
greedy tokens, and float32 keeps the two frameworks' logits within 1e-4
of their scale of each other (``test_torch_models.py``), inside the gaps
between the top two logits these runs meet.  Tokens, step counts and statistics must
be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.sched import serving as jserving
from repro.core.sched import specdecode as jspec
from repro.models import layers as jL
from repro.models import registry as jregistry

from repro_torch.core.sched import serving as tserving
from repro_torch.core.sched import specdecode as tspec
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as tregistry

ARCH = "qwen2-1.5b"


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_pair(monkeypatch, arch):
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tL, "COMPUTE_DTYPE", torch.float32)
    jm = jregistry.build_smoke(arch)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tregistry.build_smoke(arch, device="cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       tm.cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture
def pair(monkeypatch):
    return build_pair(monkeypatch, ARCH)


def requests(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(2, 9))).tolist(),
             int(rng.integers(2, 12))) for _ in range(n)]


@pytest.mark.parametrize("policy", ["ooo", "naive"])
def test_server_matches_the_reference_server(pair, policy):
    jm, jp, tm, tp = pair
    # the last request runs into max_len, which retires it early
    reqs = requests(1, 12, tm.cfg.vocab) + [(list(range(7, 32)), 12)]
    jsrv = jserving.Server(jm, jp, n_slots=4, max_len=32, policy=policy)
    tsrv = tserving.Server(tm, tp, n_slots=4, max_len=32, policy=policy)
    jreqs = [jserving.Request(i, list(p), m) for i, (p, m) in enumerate(reqs)]
    treqs = [tserving.Request(i, list(p), m) for i, (p, m) in enumerate(reqs)]
    for srv, rs in ((jsrv, jreqs), (tsrv, treqs)):
        for r in rs:
            srv.submit(r)
    jst, tst = jsrv.run(), tsrv.run()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.completed == len(reqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert all(r is None for r in tsrv.slot_req)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b",
                                  "paligemma-3b"])
def test_server_serves_the_moe_and_vlm_families_as_the_reference(
        monkeypatch, arch):
    """The MoE models decode every slot through one routing (idle slots
    fed token 0 compete for capacity, as in the reference) and paligemma
    serves text alone, at per-lane positions: the same tokens, steps and
    statistics as the JAX ``Server``."""
    jm, jp, tm, tp = build_pair(monkeypatch, arch)
    reqs = requests(3, 10, tm.cfg.vocab)
    jsrv = jserving.Server(jm, jp, n_slots=4, max_len=32)
    tsrv = tserving.Server(tm, tp, n_slots=4, max_len=32)
    jreqs = [jserving.Request(i, list(p), m) for i, (p, m) in enumerate(reqs)]
    treqs = [tserving.Request(i, list(p), m) for i, (p, m) in enumerate(reqs)]
    for srv, rs in ((jsrv, jreqs), (tsrv, treqs)):
        for r in rs:
            srv.submit(r)
    jst, tst = jsrv.run(), tsrv.run()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.completed == len(reqs) and all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_server_output_equals_unbatched_greedy_and_ooo_beats_naive(pair):
    """A slot's output equals standalone greedy decoding even when lanes
    sit at different depths; out-of-order admission takes fewer steps and
    keeps the slots busier than draining the batch."""
    _, _, tm, tp = pair
    prompt = [5, 17, 42]
    want = tspec.greedy_decode(tm, tp, np.asarray([prompt]), 6, 32)[0]
    srv = tserving.Server(tm, tp, n_slots=3, max_len=32)
    srv.submit(tserving.Request(0, [9, 3], 3))
    srv.step()
    r1 = tserving.Request(1, prompt, 6)
    srv.submit(r1)
    srv.run()
    np.testing.assert_array_equal(np.asarray(r1.out), want)

    stats = {}
    for policy in ("ooo", "naive"):
        s = tserving.Server(tm, tp, n_slots=4, max_len=32, policy=policy)
        for i, (p, m) in enumerate(requests(2, 12, 100)):
            s.submit(tserving.Request(i, p, m))
        stats[policy] = s.run()
    assert stats["ooo"].completed == stats["naive"].completed == 12
    assert stats["ooo"].steps < stats["naive"].steps
    assert stats["ooo"].utilization(4) > stats["naive"].utilization(4)


def test_greedy_decode_matches_the_reference(pair):
    jm, jp, tm, tp = pair
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
    want = jspec.greedy_decode(jm, jp, prompt, 10, 32)
    got = tspec.greedy_decode(tm, tp, prompt, 10, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("same_draft", [False, True])
def test_speculative_decode_matches_the_reference(pair, same_draft):
    """A 1-layer draft of the target's own weights, and the target as its
    own draft (every proposal accepted): the tokens and the statistics
    equal the reference's, and the tokens equal greedy decoding."""
    jm, jp, tm, tp = pair
    if same_draft:
        jd, jdp, td, tdp = jm, jp, tm, tp
    else:
        d_cfg = dataclasses.replace(jm.cfg, n_layers=1)
        jd = jregistry.build(d_cfg)
        jdp = dict(jp, layers=jax.tree.map(lambda x: x[:1], jp["layers"]))
        td = tregistry.build(d_cfg, device="cpu")
        tdp = dict(tp, layers=tp["layers"][:1])
    prompt = np.asarray([[3, 1, 4, 1, 5]])
    want, wstats = jspec.speculative_decode(jm, jp, jd, jdp, prompt, 12,
                                            k=4, max_len=32)
    got, gstats = tspec.speculative_decode(tm, tp, td, tdp, prompt, 12, k=4,
                                           max_len=32)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)
    np.testing.assert_array_equal(
        got, tspec.greedy_decode(tm, tp, prompt, 12, 32))
    if same_draft:
        assert gstats.acceptance == 1.0


def test_launcher_serves_the_smoke_model_on_the_cpu(capsys):
    stats = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "6", "--slots", "3",
                          "--policy", "naive"])
    assert stats.completed == 6
    out = capsys.readouterr().out
    assert "policy=naive completed=6" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "paligemma-3b"])
def test_launcher_serves_the_moe_and_vlm_smoke_models_on_the_cpu(capsys,
                                                                 arch):
    stats = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "5", "--slots", "2"])
    assert stats.completed == 5
    assert "completed=5" in capsys.readouterr().out


def test_launcher_and_server_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(ValueError, match="policy"):
        tserving.Server(None, None, 1, 8, policy="fifo")
