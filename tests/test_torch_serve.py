"""The port's serving slice as a whole against the reference's.

JAX ``ServeSession`` and the port's ``ServeSession`` serve ``qwen2_0_5b``
``smoke()`` (f32) from the same params (the reference's ``lm_init``,
carried across by ``params_from_numpy``).  Prefill logits and then
teacher-forced decode logits must agree within 1e-4: two f32 stacks that
run the same operations in other orders, over two layers and a 512-way
head.  Also: the port's device rules, its CLI, and that the port imports
neither ``jax`` nor ``repro``.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import ServeConfig as JServeConfig  # noqa: E402
from repro.api import ServeSession as JServeSession  # noqa: E402
from repro_torch.api import ConfigError, ServeConfig, ServeSession  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4


@pytest.mark.parametrize("use_window,prompt_len", [(False, 24), (True, 80)])
def test_serve_session_matches_reference(use_window, prompt_len):
    """With ``use_window`` the prompt (80) is longer than the smoke window
    (64), so the windowed decode masks part of the cache; prefill takes no
    window, as in the reference."""
    B, n_dec = 2, 5
    max_len = prompt_len + n_dec
    kw = dict(arch="qwen2_0_5b", smoke=True, batch=B, max_len=max_len,
              use_window=use_window)
    jsess = JServeSession.create(JServeConfig(**kw))
    config = ServeConfig(**kw, device="cpu")
    tree = jax.tree.map(np.asarray, jsess.params)
    sess = ServeSession.create(config, params_from_numpy(tree, config.model_config))

    rng = np.random.default_rng(0)
    toks = rng.integers(0, sess.cfg.vocab_size, (B, prompt_len + n_dec)).astype(np.int32)
    jl = jsess.prefill({"tokens": toks[:, :prompt_len]})
    tl = sess.prefill({"tokens": torch.from_numpy(toks[:, :prompt_len]).long()})
    assert tl.shape == (B, 1, sess.cfg.vocab_size) and tl.dtype == torch.float32
    errs = [np.abs(tl.numpy() - np.asarray(jl)).max()]
    for t in range(prompt_len, prompt_len + n_dec):
        jl = jsess.decode(toks[:, t:t + 1])
        tl = sess.decode(torch.from_numpy(toks[:, t:t + 1]).long())
        errs.append(np.abs(tl.numpy() - np.asarray(jl)).max())
    assert sess.position == jsess.position == max_len
    assert max(errs) < TOL, errs


def test_generate_is_seeded_and_shaped():
    cfg = ServeConfig(arch="qwen2-0.5b", smoke=True, batch=3, max_len=20, device="cpu",
                      seed=5)
    prompts = {"tokens": torch.randint(0, 512, (3, 12),
                                       generator=torch.Generator().manual_seed(1))}
    outs = []
    for _ in range(2):
        sess = ServeSession.create(cfg)
        outs.append(sess.generate(prompts, 6))
        assert sess.position == 12 + 5
    assert outs[0].shape == (3, 6) and outs[0].dtype == torch.long
    assert torch.equal(outs[0], outs[1])
    assert ((outs[0] >= 0) & (outs[0] < 512)).all()


def test_device_rules(monkeypatch):
    assert ServeConfig(arch="qwen2_0_5b").device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSession.create(ServeConfig(arch="qwen2_0_5b", smoke=True))


@pytest.mark.parametrize("kw,match", [
    ({"arch": "no-such-arch"}, "unknown arch"),
    ({"arch": "qwen2_0_5b", "batch": 0}, "batch"),
    ({"arch": "qwen2_0_5b", "max_len": 0}, "max_len"),
])
def test_config_errors(kw, match):
    with pytest.raises(ConfigError, match=match):
        ServeConfig(**kw)


def test_cache_overflow_raises():
    sess = ServeSession.create(ServeConfig(arch="qwen2_0_5b", smoke=True, batch=1,
                                           max_len=4, device="cpu"))
    sess.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    with pytest.raises(ValueError, match="cache full"):
        sess.decode(torch.zeros((1, 1), dtype=torch.long))


def test_cli_prints_the_reference_fields(capsys):
    from repro_torch.launch import serve
    ops.reset_launch_counts()
    serve.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen-len", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert set(rec) == {"arch", "batch", "prefill_s", "decode_tok_per_s"}
    assert rec["arch"] == "qwen2-0.5b" and rec["batch"] == 2
    assert ops.flash_attention.launches == ops.flash_decode.launches == 0   # CPU


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, bad
