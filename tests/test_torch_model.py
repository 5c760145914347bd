"""The port's model layers and params conversion against the reference.

The same numpy inputs and params (drawn by the reference's initializers)
go through ``repro.models`` and ``repro_torch.models`` on the CPU, in f32,
within 1e-5: both sides run the same f32 operations, in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm_init as jlm_init  # noqa: E402
from repro_torch.models import attention, layers, params_from_numpy  # noqa: E402
from repro_torch.models import ModelConfig, param_count  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

TOL = 1e-5


def _t(tree):
    """A reference pytree of arrays as a dict of f32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _close(port, jax_out, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_out),
                               atol=tol, rtol=0)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("layer", ["rmsnorm", "rope", "mlp"])
def test_layer_matches_reference(layer):
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    x = _randn(rng, 2, 12, 4, 64) if layer == "rope" else _randn(rng, 2, 12, 96)
    if layer == "rmsnorm":
        p = {"scale": _randn(rng, 96)}
        out, jout = layers.rmsnorm(_t(p), torch.from_numpy(x)), jlayers.rmsnorm(p, x)
    elif layer == "rope":
        pos = np.tile(np.arange(100, 112, dtype=np.int32), (2, 1))
        out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        jout = jlayers.apply_rope(x, pos, 1e6)
    else:
        p = jlayers.mlp_init(key, 96, 160, gated=True)
        out, jout = layers.mlp(_t(p), torch.from_numpy(x)), jlayers.mlp(p, x)
    _close(out, jout)


ATTN_CASES = {
    "qwen_like": jattn.AttnConfig(d_model=128, num_heads=6, num_kv_heads=2, head_dim=32,
                                  qkv_bias=True, rope_theta=1e6),
    "qk_norm": jattn.AttnConfig(d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
                                qk_norm=True),
    "window": jattn.AttnConfig(d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
                               sliding_window=8),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_apply_prefill_then_decode_matches_reference(case):
    """Prefill at cache index 0 (K2's place) then three single-token decode
    steps (K5's place), against the reference's cache-attention path."""
    jcfg = ATTN_CASES[case]
    cfg = attention.AttnConfig(**{k: v for k, v in vars(jcfg).items() if k != "chunk"})
    use_window = jcfg.sliding_window is not None
    B, S, n_dec, max_len = 2, 13, 3, 20
    rng = np.random.default_rng(3)
    jp = jattn.attention_init(jax.random.PRNGKey(2), jcfg)
    if jcfg.qkv_bias:   # the reference initializes biases to zero
        for name in ("wq", "wk", "wv"):
            jp[name]["bias"] = _randn(rng, *jp[name]["bias"].shape, scale=0.1)
    p = _t(jp)
    xs = _randn(rng, B, S + n_dec, jcfg.d_model)
    jcache = jattn.init_cache(B, max_len, jcfg.num_kv_heads, jcfg.head_dim, jnp.float32)
    cache = attention.init_cache(B, max_len, cfg.num_kv_heads, cfg.head_dim, torch.float32)

    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jout, jcache = jattn.attention_apply(jp, xs[:, :S], pos, jcfg, cache=jcache,
                                         cache_index=0, use_window=use_window)
    out, cache = attention.attention_apply(p, torch.from_numpy(xs[:, :S]),
                                           torch.from_numpy(pos), cfg, cache=cache,
                                           cache_index=0, use_window=use_window)
    _close(out, jout)
    for t in range(S, S + n_dec):
        pos = np.full((B, 1), t, np.int32)
        jout, jcache = jattn.attention_apply(jp, xs[:, t:t + 1], pos, jcfg, cache=jcache,
                                             cache_index=t, use_window=use_window)
        out, cache = attention.attention_apply(p, torch.from_numpy(xs[:, t:t + 1]),
                                               torch.from_numpy(pos), cfg, cache=cache,
                                               cache_index=t, use_window=use_window)
        _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_plain_attention_paths_match_reference():
    rng = np.random.default_rng(4)
    q, k, v = _randn(rng, 2, 9, 4, 16), _randn(rng, 2, 9, 2, 16), _randn(rng, 2, 9, 2, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(attention.attention_ref(tq, tk, tv, window=4),
           jattn.attention_ref(q, k, v, window=4))
    cache = {"k": tk, "v": tv}
    _close(attention.decode_attend(tq[:, -1:], cache, 7, window=3),
           jattn.decode_attend(q[:, -1:], {"k": k, "v": v}, 7, window=3))


@pytest.mark.parametrize("num_layers", [1, 3])
def test_params_from_numpy_layout(num_layers):
    jcfg = dataclasses.replace(jget_config("qwen2_0_5b").smoke(), num_layers=num_layers)
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), num_layers=num_layers)
    tree = jax.tree.map(np.asarray, jlm_init(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(tree, cfg, "cpu")
    assert sorted(params) == ["embed", "layers", "ln_f"]

    group = tree["stack"]["groups"][0]
    n_group_leaves = len(jax.tree.leaves(group))
    n_other = len(jax.tree.leaves(tree)) - n_group_leaves
    port_leaves = jax.tree.leaves(params)   # dicts and lists of tensors
    assert len(port_leaves) == n_other + cfg.num_layers * n_group_leaves
    assert param_count(params) == sum(a.size for a in jax.tree.leaves(tree))
    assert all(t.dtype == torch.float32 for t in port_leaves)
    assert len(params["layers"]) == cfg.num_layers
    for g, layer in enumerate(params["layers"]):
        flat_port = jax.tree_util.tree_flatten_with_path(layer)[0]
        flat_ref = dict(jax.tree_util.tree_flatten_with_path(group)[0])
        assert len(flat_port) == len(flat_ref)
        for path, leaf in flat_port:
            np.testing.assert_array_equal(leaf.numpy(), flat_ref[path][g])
    assert params["embed"]["embedding"].shape == (cfg.vocab_size, cfg.d_model)
    assert params["layers"][0]["attn"]["wq"]["kernel"].shape == (cfg.d_model,
                                                                cfg.num_heads * cfg.hd)
    with pytest.raises(ValueError, match="dense"):     # a layer count that differs
        params_from_numpy(tree, dataclasses.replace(cfg, num_layers=num_layers + 1))
    untied = dict(tree, head={"kernel": np.zeros((cfg.d_model, cfg.vocab_size))})
    with pytest.raises(ValueError, match="tied"):
        params_from_numpy(untied, cfg)


def test_config_mirrors_reference():
    for smoke in (False, True):
        c, jc = get_config("qwen2-0.5b"), jget_config("qwen2-0.5b")
        if smoke:
            c, jc = c.smoke(), jc.smoke()
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "hd", "qkv_bias", "qk_norm", "rope_theta",
                  "sliding_window", "norm_eps", "source"):
            assert getattr(c, f) == getattr(jc, f), f
        assert c.dtype == (torch.float32 if smoke else torch.bfloat16)
        assert jc.tie_embeddings and jc.block_pattern == ("attn",) and jc.mlp_gated
    assert isinstance(c, ModelConfig)
