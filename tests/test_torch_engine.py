"""The port's DuDe engine and flat optimizers against the reference's.

Eight rounds of ``DuDeEngine.round_apply`` on a fixed mask sequence (the
speed schedule of the quickstart) and the same numpy gradients go through
both of the port's backends (``reference``, and ``pallas`` = K1, whose
plain version runs on the CPU) and both of the reference's.  The slabs are
copies and round-to-nearest-even latches, so they must be bitwise equal;
g_bar, the params and the slots are f32 sums in other orders, held within
1e-5; the counters exactly.  The port's two backends sum the commits in the
same row order and must agree bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import DuDeEngine as JEngine  # noqa: E402
from repro.core.flatten import make_flat_spec as jmake_flat_spec  # noqa: E402
from repro.optim import transforms as jopt  # noqa: E402
from repro_torch.api import ConfigError, TrainerConfig  # noqa: E402
from repro_torch.core import (DuDeEngine, make_flat_spec, make_round_algo,  # noqa: E402
                              make_round_schedule, truncated_normal_speeds)
from repro_torch.optim import transforms as topt  # noqa: E402

TOL = 1e-5
N, ROUNDS = 4, 8
OPTS = {
    "sgd": ("flat_sgd", dict(lr=0.1)),
    "nesterov": ("flat_momentum_sgd", dict(lr=0.1, beta=0.9, nesterov=True)),
    "adamw": ("flat_adamw", dict(lr=1e-2, weight_decay=0.01)),
}
BUF = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(x):
    return x.float().numpy()


def _specs():
    tree = {"b": np.zeros((3, 20), np.float32), "a": np.zeros(200, np.float32)}
    return (jmake_flat_spec(tree),
            make_flat_spec({k: torch.from_numpy(v) for k, v in tree.items()}))


def _rounds():
    """Masks, fresh gradients (pad lanes zero) and initial params."""
    jspec, spec = _specs()
    assert (spec.size, spec.padded_size) == (jspec.size, jspec.padded_size) == (260, 384)
    sch = make_round_schedule(truncated_normal_speeds(N, std=1.0, seed=1), rounds=ROUNDS)
    rng = np.random.default_rng(0)
    fresh = rng.standard_normal((ROUNDS, N, spec.padded_size)).astype(np.float32)
    fresh[..., spec.size:] = 0
    w = rng.standard_normal(spec.padded_size).astype(np.float32)
    w[spec.size:] = 0
    return jspec, spec, sch, fresh, w


def _flat_slots(s):
    return [] if isinstance(s, tuple) else [s] if not isinstance(s, dict) else [s["m"], s["v"]]


@pytest.mark.parametrize("buf", list(BUF))
@pytest.mark.parametrize("opt", list(OPTS))
def test_round_apply_matches_reference(buf, opt):
    jspec, spec, sch, fresh, w0 = _rounds()
    factory, hp = OPTS[opt]
    jdt, tdt = BUF[buf]
    results = {}
    for be in ("reference", "pallas"):
        jo = getattr(jopt, factory)(**hp)
        je = JEngine(spec=jspec, n_workers=N, buffer_dtype=jdt, backend=be)
        st, w, os = je.init(), jnp.asarray(w0), jo.init(jnp.asarray(w0))
        for r in range(ROUNDS):
            st, _, w, os = je.round_apply(st, jnp.asarray(fresh[r]), jnp.asarray(sch.start[r]),
                                          jnp.asarray(sch.commit[r]), w, os, jo)
        results["jax", be] = (st, w, os)

        to = getattr(topt, factory)(**hp)
        te = DuDeEngine(spec=spec, n_workers=N, buffer_dtype=tdt, backend=be, device="cpu")
        tst, tw, tos = te.init(), torch.from_numpy(w0.copy()), to.init(torch.from_numpy(w0))
        for r in range(ROUNDS):
            tst, _, tw, tos = te.round_apply(
                tst, torch.from_numpy(fresh[r]), torch.from_numpy(sch.start[r]),
                torch.from_numpy(sch.commit[r]), tw, tos, to)
        results["torch", be] = (tst, tw, tos)

    for be in ("reference", "pallas"):
        (jst, jw, jos), (tst, tw, tos) = results["jax", be], results["torch", be]
        for name in ("g_workers", "inflight"):
            assert getattr(tst, name).dtype == tdt
            np.testing.assert_array_equal(_tnp(getattr(tst, name)), _np(getattr(jst, name)))
        np.testing.assert_array_equal(tst.acc_count.numpy(), np.asarray(jst.acc_count))
        assert int(tst.step) == int(jst.step) == ROUNDS == int(tos.step) == int(jos.step)
        np.testing.assert_allclose(_tnp(tst.g_bar), _np(jst.g_bar), atol=TOL, rtol=0)
        np.testing.assert_allclose(_tnp(tw), _np(jw), atol=TOL, rtol=0)
        for a, b in zip(_flat_slots(tos.slots), _flat_slots(jos.slots)):
            np.testing.assert_allclose(_tnp(a), _np(b), atol=TOL, rtol=0)
    (rst, rw, ros), (pst, pw, pos) = results["torch", "reference"], results["torch", "pallas"]
    for a, b in zip([rst.g_bar, rst.g_workers, rst.inflight, rw] + _flat_slots(ros.slots),
                    [pst.g_bar, pst.g_workers, pst.inflight, pw] + _flat_slots(pos.slots)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_round_matches_reference(backend):
    """The round without the optimizer (``DuDeEngine.round``)."""
    jspec, spec, sch, fresh, _ = _rounds()
    je = JEngine(spec=jspec, n_workers=N, buffer_dtype=jnp.bfloat16, backend=backend)
    te = DuDeEngine(spec=spec, n_workers=N, buffer_dtype=torch.bfloat16, backend=backend,
                    device="cpu")
    algo = make_round_algo("dude", te)
    jst, tst, ast = je.init(), te.init(), algo.init()
    for r in range(ROUNDS):
        jst, jg = je.round(jst, jnp.asarray(fresh[r]), jnp.asarray(sch.start[r]),
                           jnp.asarray(sch.commit[r]))
        tst, tg = te.round(tst, torch.from_numpy(fresh[r]), torch.from_numpy(sch.start[r]),
                           torch.from_numpy(sch.commit[r]))
        np.testing.assert_allclose(_tnp(tg), _np(jg), atol=TOL, rtol=0)
        ast, ag, applied = algo.round(ast, torch.from_numpy(fresh[r]),   # the rule's round
                                      torch.from_numpy(sch.start[r]),
                                      torch.from_numpy(sch.commit[r]))
        assert torch.equal(ag, tg) and bool(applied)
    np.testing.assert_array_equal(_tnp(tst.g_workers), _np(jst.g_workers))
    np.testing.assert_array_equal(_tnp(tst.inflight), _np(jst.inflight))
    # the incremental aggregation invariant: g_bar is the mean of the rows
    np.testing.assert_allclose(_tnp(tst.g_bar), _tnp(tst.g_workers).mean(0), atol=TOL)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov", "adamw"])
def test_flat_optimizer_update_matches_reference(opt):
    """``FlatOptimizer.update`` over three steps; the same f32 elementwise
    ops in the same order (AdamW's f32 ``b ** t`` may differ in the last
    place), within 1e-6."""
    factory, hp = OPTS.get(opt, ("flat_momentum_sgd", dict(lr=0.1, beta=0.9)))
    rng = np.random.default_rng(5)
    P = 256
    w = rng.standard_normal(P).astype(np.float32)
    jo, to = getattr(jopt, factory)(**hp), getattr(topt, factory)(**hp)
    assert (jo.name, jo.hparams) == (to.name, to.hparams)
    jw, js = jnp.asarray(w), jo.init_slots(jnp.asarray(w))
    tw, ts = torch.from_numpy(w), to.init_slots(torch.from_numpy(w))
    for t in (1, 2, 3):
        g = rng.standard_normal(P).astype(np.float32)
        jw, js = jo.update(jw, jnp.asarray(g), js, jnp.asarray(t, jnp.int32))
        tw, ts = to.update(tw, torch.from_numpy(g), ts, torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-6, rtol=0)
        for a, b in zip(_flat_slots(ts), _flat_slots(js)):
            np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6, rtol=0)
    # the descriptors rebuild the same flat twin
    desc = {"sgd": topt.sgd(0.1), "adamw": topt.adamw(1e-2, weight_decay=0.01)}.get(opt)
    if desc is not None:
        assert topt.flat_twin(desc) == to


def test_what_is_not_yet_ported_raises():
    _, spec = _specs()
    for kw in (dict(backend="indexed"), dict(accumulate=True),
               dict(commit_format="int8_ef"), dict(sparse_meta=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            DuDeEngine(spec=spec, n_workers=N, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        DuDeEngine(spec=spec, n_workers=N, backend="fused", device="cpu")
    eng = DuDeEngine(spec=spec, n_workers=N, device="cpu")
    for name in ("dude_accum", "sync_sgd", "mifa", "fedbuff"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            make_round_algo(name, eng)
    assert make_round_algo("dude", eng).fused_apply
    for kw in (dict(algo="fedbuff"), dict(algo="shuffled_asgd"),
               dict(server_backend="indexed")):
        with pytest.raises(ConfigError, match="not yet ported"):
            TrainerConfig(arch="qwen2_0_5b", **kw)
    with pytest.raises(ConfigError, match="unknown"):
        TrainerConfig(arch="qwen2_0_5b", optimizer="lion")
