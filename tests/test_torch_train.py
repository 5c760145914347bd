"""The port's training slice against the reference's, on the CPU.

The same params (drawn by the reference's ``lm_init``) and the same numpy
batches go through ``repro`` and ``repro_torch``, in f32:
* the loss of one worker's batch and the ``[n, P]`` fresh slab of one
  train step (read back from the in-flight slab, which a round where every
  worker starts and none commits latches unchanged), within 1e-5 (both
  sides run the same f32 operations, in other orders);
* a twin of ``examples/quickstart.py``: 60 masked rounds through
  ``Trainer.step`` on each backend, whose per-round losses track the JAX
  ``Trainer``'s within ``TRACK_TOL``.
It also checks the device rules and the training CLI.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Trainer as JTrainer  # noqa: E402
from repro.api import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import make_token_sampler as jmake_token_sampler  # noqa: E402
from repro.models import lm_init as jlm_init  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.api import ServeConfig, ServeSession, Trainer, TrainerConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import make_round_schedule, truncated_normal_speeds  # noqa: E402
from repro_torch.data import make_token_sampler  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ModelConfig, loss_fn, params_from_numpy  # noqa: E402

TOL = 1e-5
# 60 rounds of SGD (lr 0.05) from the same params: the two frameworks round
# each f32 op differently, and the rounding compounds through the updates
# (the largest gap measured on the CPU is 5.7e-6).
TRACK_TOL = 1e-4
QUICKSTART = dict(name="quickstart-lm", num_layers=2, d_model=128, num_heads=4,
                  num_kv_heads=2, d_ff=256, vocab_size=256, remat=False, attn_chunk=32,
                  n_workers=4)


def _batches(cfg, rounds, seq, batch, seed=0):
    """Worker-stacked numpy batches from the port's copy of the sampler,
    which must draw what the reference's draws."""
    port = make_token_sampler(cfg.n_workers, cfg.vocab_size, seq, batch,
                              heterogeneity=2.0, seed=seed)
    ref = jmake_token_sampler(cfg.n_workers, cfg.vocab_size, seq, batch,
                              heterogeneity=2.0, seed=seed)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        per = [port(i, rng) for i in range(cfg.n_workers)]
        jper = [ref(i, jrng) for i in range(cfg.n_workers)]
        assert all(np.array_equal(p[k], j[k]) for p, j in zip(per, jper) for k in p)
        out.append({k: np.stack([p[k] for p in per]) for k in per[0]})
    return out


@pytest.mark.parametrize("ce_chunk,remat", [(0, False), (8, True)])
def test_loss_and_fresh_slab_match_reference(ce_chunk, remat):
    jcfg = dataclasses.replace(jget_config("qwen2_0_5b").smoke(), ce_chunk=ce_chunk,
                               remat=remat)
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), ce_chunk=ce_chunk,
                              remat=remat)
    tree = jlm_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, tree), cfg)
    (batch,) = _batches(cfg, 1, seq=20, batch=2)

    wb = {k: v[1] for k, v in batch.items()}
    jloss, _ = jloss_fn(tree, {k: jnp.asarray(v) for k, v in wb.items()}, jcfg)
    loss, metrics = loss_fn(params, {k: torch.from_numpy(v) for k, v in wb.items()}, cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=0)
    assert float(metrics["aux"]) == 0.0

    start, commit = np.ones(cfg.n_workers, bool), np.zeros(cfg.n_workers, bool)
    jt = JTrainer.create(JTrainerConfig(arch=jcfg, buffer_dtype=jnp.float32), params=tree)
    jm = jt.step({k: jnp.asarray(v) for k, v in batch.items()}, start, commit)
    t = Trainer.create(TrainerConfig(arch=cfg, buffer_dtype=torch.float32, device="cpu"),
                       params=params)
    m = t.step(batch, start, commit)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=TOL, rtol=0)
    fresh = t.state.engine.inflight                 # f32 here: the latch is exact
    assert fresh.dtype == torch.float32 and fresh.shape == (cfg.n_workers, t.engine.P)
    np.testing.assert_allclose(fresh.numpy(), np.asarray(jt.state.engine.inflight),
                               atol=TOL, rtol=0)
    assert not t.state.engine.g_bar.any()           # nothing committed yet


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_quickstart_twin_tracks_reference(backend):
    """examples/quickstart.py's session: 4 workers with truncated-normal
    speeds, skewed token data, SGD lr 0.05, 60 masked rounds."""
    jcfg = JModelConfig(arch_type="dense", dtype=jnp.float32, **QUICKSTART)
    cfg = ModelConfig(dtype=torch.float32, **QUICKSTART)
    tree = jlm_init(jax.random.PRNGKey(0), jcfg)
    jt = JTrainer.create(JTrainerConfig(arch=jcfg, algo="dude", optimizer="sgd", lr=0.05,
                                        server_backend=backend), params=tree)
    t = Trainer.create(TrainerConfig(arch=cfg, algo="dude", optimizer="sgd", lr=0.05,
                                     server_backend=backend, device="cpu"),
                       params=params_from_numpy(jax.tree.map(np.asarray, tree), cfg))
    assert t.state.engine.g_workers.dtype == torch.bfloat16   # the arch's buffers
    schedule = make_round_schedule(truncated_normal_speeds(cfg.n_workers, std=1.0, seed=1),
                                   rounds=60)
    jl, tl = [], []
    for r, batch in enumerate(_batches(cfg, schedule.rounds, seq=32, batch=2)):
        jl.append(float(jt.step({k: jnp.asarray(v) for k, v in batch.items()},
                                schedule.start[r], schedule.commit[r])["loss"]))
        tl.append(t.step(batch, schedule.start[r], schedule.commit[r])["loss"])
    tl = torch.stack(tl).numpy()
    np.testing.assert_allclose(tl, np.asarray(jl), atol=TRACK_TOL, rtol=0)
    assert tl[-1] < tl[0] - 0.1                         # it learns
    assert ops.dude_round_apply.launches == 0           # the CPU runs the plain version
    assert t.rounds == 60 and t.param_count() == t.engine.spec.size


def test_device_rules(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.create(TrainerConfig(arch="qwen2_0_5b", smoke=True))
    assert TrainerConfig(arch="qwen2_0_5b").device == "cuda"
    t = Trainer.create(TrainerConfig(arch="qwen2_0_5b", smoke=True, device="cpu"))
    assert t.state.params.device.type == "cpu"
    # params() are views of the master vector, and ServeSession takes them
    params = t.params()
    assert params["layers"][0]["mlp"]["up"]["kernel"].untyped_storage().data_ptr() == \
        t.state.params.untyped_storage().data_ptr()
    sess = ServeSession.create(ServeConfig(arch="qwen2_0_5b", smoke=True, batch=1, max_len=8,
                                           device="cpu"), params=params)
    logits = sess.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert logits.shape == (1, 1, t.cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_cli_prints_the_reference_fields(capsys):
    from repro_torch.launch import train
    ops.reset_launch_counts()
    train.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--rounds", "3",
                "--seq-len", "16", "--per-worker-batch", "1", "--server-backend", "pallas"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"arch", "algo", "mode", "rounds", "first_loss", "last_loss", "wall_s"}
    assert rec["rounds"] == 3 and np.isfinite([rec["first_loss"], rec["last_loss"]]).all()
    assert ops.dude_round_apply.launches == 0
    with pytest.raises(SystemExit):
        train.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--lr", "0"])
