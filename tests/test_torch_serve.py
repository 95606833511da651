"""The port's serving plane against the JAX package's: the same requests
through the JAX ``MCServeEngine``, the JAX standalone engine and the port's
``MCServeEngine`` give the same moments, series and streamed snapshots,
bitwise — across bucket widths, chunk sizes, mid-flight submission and
neighbours — plus the port's own invariants (pad slots never leak, random
submit/cancel schedules drain), the per-slot step of the sweep families,
the scheduler, and the launcher's output lines.

The JAX references are computed once per file (module-scoped caches).
"""
import dataclasses
import functools
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import REPO, SRC  # noqa: E402
from repro.api import IsingEngine as JEngine  # noqa: E402
from repro.api import engine as japi  # noqa: E402
from repro.serve import MCServeEngine as JServe  # noqa: E402
from repro.serve import SimRequest as JRequest  # noqa: E402
from repro.serve import engine as jserve_engine  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.api import engine as api_engine  # noqa: E402
from repro_torch.serve import (CANCELLED, DONE, BucketScheduler,  # noqa
                               MCServeEngine, SimRequest)
from repro_torch.serve import engine as serve_engine  # noqa: E402


def assert_bitwise_moments(got: dict, want: dict, label: str = ""):
    assert set(got) == set(want), label
    for k in want:
        assert got[k] == want[k], \
            f"{label} moments[{k}]: port={got[k]!r} reference={want[k]!r}"


def _serve(width, chunk, reqs):
    return MCServeEngine(replica_width=width, chunk_sweeps=chunk,
                         device="cpu").serve(reqs)


def _jreq(req: SimRequest) -> JRequest:
    return JRequest(**dataclasses.asdict(req))


@functools.lru_cache(maxsize=None)
def jax_standalone(req: SimRequest):
    """The JAX engine's standalone run of ``req``: (moments, m, E)."""
    r = JEngine(_jreq(req).engine_config()).simulate(seed=req.seed)
    return (r.moments, np.asarray(r.magnetization, np.float32),
            np.asarray(r.energy, np.float32))


@functools.lru_cache(maxsize=None)
def jax_served(width, chunk, reqs: tuple) -> list:
    """The JAX serving plane's results: (moments, m, E, snapshots)."""
    out = JServe(replica_width=width, chunk_sweeps=chunk).serve(
        [_jreq(r) for r in reqs])
    return [(r.moments, np.asarray(r.magnetization),
             np.asarray(r.energy),
             [(u.sweeps_done, u.done, u.moments) for u in r.updates])
            for r in out]


# ---------------------------------------------------------------------------
# 1. Bitwise batching-independence, against both JAX paths
# ---------------------------------------------------------------------------

# every dynamics family the serving plane routes: compact-quad
# checkerboard (Metropolis, heat-bath), full-view cluster (SW, Wolff),
# Potts checkerboard and cluster, and the 3-D cube
MIXED_REQUESTS = (
    SimRequest(L=16, beta=0.3, n_sweeps=14, n_samples=2, seed=11),
    SimRequest(L=16, beta=0.6, n_sweeps=9, n_samples=3, seed=12,
               rule="heat_bath"),
    SimRequest(L=16, beta=0.44, n_sweeps=7, n_samples=1, seed=13,
               algorithm="swendsen_wang", dtype="float32"),
    SimRequest(L=16, beta=0.5, n_sweeps=11, n_samples=2, seed=14,
               algorithm="wolff", dtype="float32"),
    SimRequest(L=16, beta=1.1, n_sweeps=13, n_samples=2, seed=15,
               model="potts", q=3, rule="heat_bath"),
    SimRequest(L=16, beta=0.9, n_sweeps=8, n_samples=2, seed=16,
               model="potts", q=3, algorithm="swendsen_wang"),
    SimRequest(L=8, beta=0.25, n_sweeps=10, n_samples=2, seed=17, dims=3),
)


@pytest.mark.parametrize("width,chunk", [(1, 4), (4, 16), (3, 5)])
def test_served_bitwise_equals_jax_served_and_standalone(width, chunk):
    """Every served request's moments, series and streamed snapshots equal
    the JAX serving plane's and the JAX standalone engine's, across widths
    and chunk sizes that move padding, packing and chunk boundaries."""
    results = _serve(width, chunk, list(MIXED_REQUESTS))
    served = jax_served(width, chunk, MIXED_REQUESTS)
    for req, res, (jmom, jm, je, jups) in zip(MIXED_REQUESTS, results,
                                              served):
        label = f"width={width} chunk={chunk} req={req}"
        assert res.status == DONE
        assert_bitwise_moments(res.moments, jmom, label)
        smom, sm, se = jax_standalone(req)
        assert_bitwise_moments(res.moments, smom, label)
        for got, a, b in ((res.magnetization, jm, sm),
                          (res.energy, je, se)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, a)
            np.testing.assert_array_equal(got, b)
        assert [(u.sweeps_done, u.done, u.moments)
                for u in res.updates] == jups, label


def test_served_bitwise_with_midflight_submission():
    """Requests admitted into slots freed mid-run still reproduce their
    JAX standalone runs bitwise."""
    engine = MCServeEngine(replica_width=2, chunk_sweeps=4, device="cpu")
    first, late = MIXED_REQUESTS[:3], MIXED_REQUESTS[3:]
    rids = [engine.submit(r) for r in first]
    engine.step()
    engine.step()                       # some chains mid-flight now
    rids += [engine.submit(r) for r in late]
    engine.run_until_idle()
    for req, rid in zip(first + late, rids):
        assert engine.status(rid) == DONE
        assert_bitwise_moments(engine.result(rid).moments,
                               jax_standalone(req)[0], f"req={req}")


def test_intermediate_snapshots_bitwise_equal_shorter_runs():
    """A streamed snapshot at p sweeps equals a standalone run of p sweeps
    (the JAX engine's), bitwise."""
    req = SimRequest(L=16, beta=0.44, n_sweeps=12, n_samples=4, seed=5)
    (res,) = _serve(2, 5, [req])
    assert [u.sweeps_done for u in res.updates] == [3, 6, 9, 12]
    for upd in res.updates:
        short = dataclasses.replace(req, n_sweeps=upd.sweeps_done,
                                    n_samples=1)
        assert_bitwise_moments(upd.moments, jax_standalone(short)[0],
                               f"snapshot@{upd.sweeps_done}")


def test_series_bitwise_equal_standalone():
    """The full (m, E) series handed back is the standalone engine's, the
    port's and the JAX package's."""
    req = SimRequest(L=16, beta=0.5, n_sweeps=10, seed=3)
    ref = IsingEngine(req.engine_config(), device="cpu").simulate(req.seed)
    (res,) = _serve(4, 3, [req])
    _, jm, je = jax_standalone(req)
    np.testing.assert_array_equal(res.magnetization, ref.magnetization)
    np.testing.assert_array_equal(res.energy, ref.energy)
    np.testing.assert_array_equal(res.magnetization, jm)
    np.testing.assert_array_equal(res.energy, je)


# ---------------------------------------------------------------------------
# 2. Padding hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("req", [
    MIXED_REQUESTS[0], MIXED_REQUESTS[2], MIXED_REQUESTS[4],
    MIXED_REQUESTS[6]], ids=["ising-cb", "ising-sw", "potts-hb", "3d"])
def test_padding_slots_never_leak(req):
    """One request alone in an 8-wide bucket (7 zero pad slots swept
    alongside it, their cluster labels included) == the same request at
    width 1, bitwise."""
    (wide,) = _serve(8, 4, [req])
    (solo,) = _serve(1, 4, [req])
    assert_bitwise_moments(wide.moments, solo.moments, f"req={req}")
    np.testing.assert_array_equal(wide.magnetization, solo.magnetization)
    np.testing.assert_array_equal(wide.energy, solo.energy)


def test_pad_slot_sweeps_the_zero_template():
    """Every family sweeps its zero template under PRNGKey(0) at beta 0.5
    without an error, and the template keeps its layout."""
    for req in MIXED_REQUESTS:
        cfg = req.engine_config()
        tmpl = serve_engine.slot_template(cfg, "cpu")
        assert not tmpl.any()
        _, measured, rep_args = api_engine.replica_sweep_fns(cfg)
        st, (m, e) = measured(torch.stack([tmpl, tmpl]),
                              [jr.PRNGKey(0)] * 2,
                              rep_args([0.5, 0.5], "cpu"), [0, 0])
        assert st.shape == (2,) + tmpl.shape and st.dtype == tmpl.dtype
        assert m.shape == (2,) and torch.isfinite(e).all()


def test_neighbour_requests_never_leak():
    """A request's stream is unchanged by who shares its bucket."""
    probe = SimRequest(L=16, beta=0.44, n_sweeps=10, n_samples=2, seed=99)
    neighbour_sets = [
        [],
        [SimRequest(L=16, beta=0.3, n_sweeps=20, seed=1)],
        [SimRequest(L=16, beta=0.7, n_sweeps=4, seed=i, rule="heat_bath")
         for i in range(3)],
    ]
    outs = [_serve(4, 4, [probe] + others)[0].moments
            for others in neighbour_sets]
    for mom in outs:
        assert_bitwise_moments(mom, jax_standalone(probe)[0],
                               "neighbour leak")


# ---------------------------------------------------------------------------
# 3. Liveness under randomized submit/cancel schedules
# ---------------------------------------------------------------------------

def _random_request(rng: random.Random) -> SimRequest:
    n_sweeps = rng.randrange(1, 12)
    kw = dict(L=16, n_sweeps=n_sweeps,
              n_samples=rng.randrange(1, min(2, n_sweeps) + 1),
              seed=rng.randrange(1000),
              rule=rng.choice(("metropolis", "heat_bath")))
    if rng.random() < 0.3:
        return SimRequest(beta=rng.uniform(0.8, 1.2), model="potts",
                          q=rng.choice((2, 3)), **kw)
    return SimRequest(beta=rng.uniform(0.3, 0.6), **kw)


@pytest.mark.parametrize("schedule_seed", [0, 1, 2])
def test_randomized_submit_cancel_schedules_drain(schedule_seed):
    """Arbitrary interleavings of submit / cancel / step drain: every
    surviving request reaches DONE with exactly n_samples snapshots and
    its standalone moments, cancelled ones stay CANCELLED with no final
    snapshot, and the engine ends idle. Seeded, so failures replay."""
    rng = random.Random(schedule_seed)
    engine = MCServeEngine(replica_width=2, chunk_sweeps=3, device="cpu")
    live, cancelled = {}, set()
    for _ in range(40):
        action = rng.random()
        if action < 0.45:
            req = _random_request(rng)
            live[engine.submit(req)] = req
        elif action < 0.65 and live:
            rid = rng.choice(sorted(live))
            if engine.cancel(rid):
                cancelled.add(rid)
        else:
            engine.step()
    results = engine.run_until_idle(max_steps=10_000)
    assert engine.idle
    assert set(results) == set(live)
    for rid, req in live.items():
        res = results[rid]
        if rid in cancelled:
            assert res.status == CANCELLED
            assert all(not u.done for u in res.updates)
            continue
        assert res.status == DONE, f"request {rid} starved: {res.status}"
        assert len(res.updates) == req.n_samples
        assert res.updates[-1].sweeps_done == req.n_sweeps
        want = IsingEngine(req.engine_config(),
                           device="cpu").simulate(req.seed).moments
        assert_bitwise_moments(res.moments, want, f"req={req}")


def test_cancel_running_frees_slot_for_queued_request():
    engine = MCServeEngine(replica_width=1, chunk_sweeps=2, device="cpu")
    long_rid = engine.submit(SimRequest(L=16, beta=0.4, n_sweeps=50,
                                        seed=0))
    short_rid = engine.submit(SimRequest(L=16, beta=0.4, n_sweeps=4,
                                         seed=1))
    engine.step()                        # long occupies the only slot
    assert engine.cancel(long_rid)
    engine.run_until_idle()
    assert engine.status(long_rid) == CANCELLED
    assert engine.status(short_rid) == DONE
    assert not engine.cancel(short_rid)


@pytest.mark.parametrize("kw", [dict(n_sweeps=0), dict(n_sweeps=4,
                                                        n_samples=9),
                                dict(n_sweeps=4, L=15),
                                dict(n_sweeps=4, model="potts", q=1)])
def test_submit_rejects_malformed_requests(kw):
    """Malformed requests raise the reference's messages, word for word."""
    req = dataclasses.replace(SimRequest(L=16, beta=0.4, n_sweeps=1), **kw)
    with pytest.raises(ValueError) as want:
        JServe().submit(_jreq(req))
    engine = MCServeEngine(device="cpu")
    with pytest.raises(ValueError) as got:
        engine.submit(req)
    assert str(got.value) == str(want.value)
    assert engine.idle
    for bad in (dict(replica_width=0), dict(chunk_sweeps=0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            MCServeEngine(device="cpu", **bad)


def test_serve_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert MCServeEngine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MCServeEngine()


# ---------------------------------------------------------------------------
# RNG contract: fold_in chain keys, per-slot steps, slot permutations
# ---------------------------------------------------------------------------

RNG_CASES = [
    ("ising", "metropolis", 2), ("ising", "swendsen_wang", 2),
    ("ising", "metropolis", 3), ("potts", "metropolis", 2),
    ("potts", "swendsen_wang", 2),
]


def _rng_cfg(model, algorithm, dims) -> dict:
    size = 8 if dims == 3 else 16
    dtype = "bfloat16" if (model, algorithm) == ("ising",
                                                 "metropolis") else "float32"
    return dict(size=size, beta=0.5, n_sweeps=1, model=model,
                q=3 if model == "potts" else 0, dims=dims,
                algorithm=algorithm, dtype=dtype, measure=True)


def _chain_series(cfg, states, chain_keys, n_sweeps: int,
                  offsets=None) -> np.ndarray:
    """m-series [n_chains, n_sweeps] through the shared replica sweep
    family, each chain at its own step when ``offsets`` is given."""
    _, measured, rep_args = api_engine.replica_sweep_fns(cfg)
    n = len(chain_keys)
    args = rep_args([cfg.beta] * n, "cpu")
    offsets = offsets or [0] * n
    s, ms = torch.stack(states), []
    for j in range(n_sweeps):
        s, (m, _) = measured(s, list(chain_keys), args,
                             [o + j for o in offsets])
        ms.append(m)
    return torch.stack(ms, -1).numpy()


def _jax_chain_series(cfg, states, chain_keys, n_sweeps: int) -> np.ndarray:
    """The JAX serving plane's vmapped scan over the same family."""
    _, measured, rep_args = japi.replica_sweep_fns(cfg)
    n = len(chain_keys)
    args = rep_args(jnp.full((n,), cfg.beta, jnp.float32))
    offsets = jnp.zeros((n,), jnp.int32)

    def body(carry, j):
        s, (m, _) = jax.vmap(measured, in_axes=(0, 0, 0, 0))(
            carry, jnp.stack(chain_keys), args, offsets + j)
        return s, m

    _, ms = jax.lax.scan(body, jnp.stack(states), jnp.arange(n_sweeps))
    return np.asarray(ms.T, np.float32)


def _slot_states(kw, seeds):
    from repro.api import EngineConfig as JConfig
    cfg, jcfg = EngineConfig(**kw), JConfig(**kw)
    eng, jeng = IsingEngine(cfg, device="cpu"), JEngine(jcfg)
    states = [serve_engine._slot_state(cfg, eng, jr.PRNGKey(s))
              for s in seeds]
    jstates = [jserve_engine._slot_state(jcfg, jeng, jax.random.PRNGKey(s))
               for s in seeds]
    return cfg, jcfg, states, jstates


@pytest.mark.parametrize("model,algorithm,dims", RNG_CASES)
def test_fold_in_slot_keys_pairwise_independent(model, algorithm, dims):
    """Distinct slot keys ``fold_in(key, i)`` on identical states give
    distinct m-series."""
    cfg, _, (state,), _ = _slot_states(_rng_cfg(model, algorithm, dims),
                                       [42])
    keys = [jr.fold_in(jr.PRNGKey(7), i) for i in range(3)]
    series = _chain_series(cfg, [state] * 3, keys, n_sweeps=6)
    for i in range(3):
        for j in range(i + 1, 3):
            assert not np.array_equal(series[i], series[j])


@pytest.mark.parametrize("model,algorithm,dims", RNG_CASES)
def test_slot_permutation_invariance(model, algorithm, dims):
    """A chain's stream is a function of (state, key, step) only: the
    series equal the JAX serving plane's vmapped scan, and permuting the
    slots permutes the series, bitwise."""
    cfg, jcfg, states, jstates = _slot_states(
        _rng_cfg(model, algorithm, dims), range(3))
    for s, js in zip(states, jstates):
        np.testing.assert_array_equal(s.float().numpy(),
                                      np.asarray(js, np.float32))
    keys = [jr.fold_in(jr.PRNGKey(7), i) for i in range(3)]
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(3)]
    base = _chain_series(cfg, states, keys, n_sweeps=5)
    np.testing.assert_array_equal(
        base, _jax_chain_series(jcfg, jstates, jkeys, n_sweeps=5))
    perm = [2, 0, 1]
    permuted = _chain_series(cfg, [states[p] for p in perm],
                             [keys[p] for p in perm], n_sweeps=5)
    for slot, p in enumerate(perm):
        np.testing.assert_array_equal(permuted[slot], base[p])


@pytest.mark.parametrize("model,algorithm,dims", RNG_CASES)
def test_per_slot_steps(model, algorithm, dims):
    """A step list equal in every slot is the single-step call, bitwise;
    slots at different steps each equal that chain swept alone from its
    own step."""
    cfg, _, states, _ = _slot_states(_rng_cfg(model, algorithm, dims),
                                     range(3))
    keys = [jr.fold_in(jr.PRNGKey(9), i) for i in range(3)]
    _, measured, rep_args = api_engine.replica_sweep_fns(cfg)
    args = rep_args([cfg.beta] * 3, "cpu")
    stack = torch.stack(states)
    a, (ma, ea) = measured(stack, keys, args, 4)
    b, (mb, eb) = measured(stack, keys, args, [4, 4, 4])
    assert torch.equal(a, b) and torch.equal(ma, mb) and torch.equal(ea, eb)
    offsets = [0, 5, 11]
    mixed = _chain_series(cfg, states, keys, 3, offsets)
    for i, off in enumerate(offsets):
        alone = _chain_series(cfg, [states[i]], [keys[i]], 3, [off])
        np.testing.assert_array_equal(mixed[i], alone[0])


def test_submission_order_is_slot_assignment_invariance():
    """Submitting the same requests in a different order lands them in
    different slots, each result bitwise unchanged."""
    reqs = [SimRequest(L=16, beta=0.35 + 0.05 * i, n_sweeps=8, seed=20 + i)
            for i in range(4)]
    fwd = _serve(4, 4, reqs)
    rev = _serve(4, 4, reqs[::-1])
    for req, a, b in zip(reqs, fwd, rev[::-1]):
        assert_bitwise_moments(a.moments, b.moments, f"req={req}")


# ---------------------------------------------------------------------------
# BucketScheduler unit tests
# ---------------------------------------------------------------------------

def test_scheduler_fifo_within_bucket():
    s = BucketScheduler()
    for rid in (3, 1, 2):
        s.submit(rid, ("a",))
    assert s.peek(("a",)) == 3
    assert s.take(("a",), 2) == [3, 1]
    assert s.take(("a",), 5) == [2]
    assert s.take(("a",), 1) == []
    assert s.pending() == 0


def test_scheduler_round_robin_across_buckets():
    s = BucketScheduler()
    for rid, key in [(0, ("a",)), (1, ("a",)), (2, ("b",)), (3, ("c",))]:
        s.submit(rid, key)
    seen = [s.next_bucket() for _ in range(6)]
    assert set(seen[:3]) == {("a",), ("b",), ("c",)}
    assert seen[:3] == seen[3:6], "rotation must cycle deterministically"


def test_scheduler_next_bucket_exclude_and_exhaustion():
    s = BucketScheduler()
    s.submit(0, ("a",))
    s.submit(1, ("b",))
    assert s.next_bucket(exclude=(("a",),)) == ("b",)
    s.take(("b",), 1)
    assert s.next_bucket(exclude=(("a",),)) is None
    assert s.buckets() == [("a",)]


def test_scheduler_cancel_pending():
    s = BucketScheduler()
    s.submit(0, ("a",))
    s.submit(1, ("a",))
    assert s.cancel(0)
    assert not s.cancel(0)
    assert not s.cancel(42)
    assert s.take(("a",), 4) == [1]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_matches_jax_launcher():
    """``repro_torch.launch.serve --device cpu --verify`` prints the JAX
    launcher's ``[serve] req`` lines for the same workload, and its own
    bitwise check passes."""
    args = ["--requests", "5", "--sizes", "8,16", "--sweeps", "6",
            "--samples", "2", "--replica-width", "2", "--chunk", "4",
            "--seed", "3", "--verify"]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-m", mod] + args + extra,
                              cwd=str(REPO), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for mod, extra in (("repro.launch.serve", []),
                                ("repro_torch.launch.serve",
                                 ["--device", "cpu", "--chunk-stats"]))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{out}\n{err}"
        outs.append(out)

    def req_lines(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("[serve] req")]
    assert len(req_lines(outs[0])) == 10
    assert req_lines(outs[1]) == req_lines(outs[0])
    assert "(req 0 vs standalone engine): OK" in outs[1]
    assert "outside the sweeps" in outs[1]
