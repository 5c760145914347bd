"""The port's flat layout (``repro_torch.core.flatten``) against the
reference's ``repro.core.flatten``.

The segment table (leaf paths, offsets, sizes, shapes, padded size,
dtypes) must be the reference's exactly, and the ravelled vector of the
same params bitwise equal: the layout is copied, not computed in another
order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.flatten import make_flat_spec as jmake_flat_spec  # noqa: E402
from repro.launch.steps import abstract_params as jabstract_params  # noqa: E402
from repro.models import lm_init as jlm_init  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flatten import (PAD_MULTIPLE, make_flat_spec, tree_flatten,  # noqa: E402
                                      tree_unflatten)
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.models import (ModelConfig, params_from_numpy, params_from_stacked,  # noqa: E402
                                stack_params)

# the quickstart's model (examples/quickstart.py), on both sides
QUICKSTART = dict(name="quickstart-lm", num_layers=2, d_model=128, num_heads=4,
                  num_kv_heads=2, d_ff=256, vocab_size=256, remat=False, attn_chunk=32,
                  n_workers=4)


def _configs(which):
    if which == "quickstart":
        return (JModelConfig(arch_type="dense", dtype=jnp.float32, **QUICKSTART),
                ModelConfig(dtype=torch.float32, **QUICKSTART))
    jc, c = jget_config("qwen2_0_5b"), get_config("qwen2_0_5b")
    return (jc.smoke(), c.smoke()) if which == "smoke" else (jc, c)


def _keystr(path):
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


@pytest.mark.parametrize("which", ["smoke", "quickstart", "full"])
def test_segment_table_is_the_references(which):
    jc, c = _configs(which)
    jtree = jabstract_params(jc)
    jspec = jmake_flat_spec(jtree)
    spec = make_flat_spec(abstract_params(c))
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [_keystr(p) for p in spec.paths] == jpaths
    assert spec.shapes == jspec.shapes
    assert spec.sizes == jspec.sizes
    assert spec.offsets == jspec.offsets
    assert (spec.size, spec.padded_size) == (jspec.size, jspec.padded_size)
    assert [str(d).removeprefix("torch.") for d in spec.dtypes] == \
        [np.dtype(d).name for d in jspec.dtypes]
    if which == "full":   # qwen2-0.5b: P is already a multiple of the pad
        assert spec.padded_size == spec.size == 494_032_768


@pytest.mark.parametrize("which", ["smoke", "quickstart"])
def test_ravel_is_bitwise_the_references(which):
    jc, c = _configs(which)
    tree = jlm_init(jax.random.PRNGKey(3), jc)
    want = np.asarray(jmake_flat_spec(tree).ravel(tree))
    params = params_from_numpy(jax.tree.map(np.asarray, tree), c)
    spec = make_flat_spec(abstract_params(c))
    got = spec.ravel(stack_params(params)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not got[spec.size:].any()           # pad lanes zero


def test_ravel_stacked_is_bitwise_the_references():
    jc, c = _configs("quickstart")
    rng = np.random.default_rng(0)
    jtree = jabstract_params(jc)
    leaves, treedef = jax.tree.flatten(jtree)
    stacked = jax.tree.unflatten(treedef, [rng.standard_normal((3,) + s.shape).astype(np.float32)
                                           for s in leaves])
    want = np.asarray(jmake_flat_spec(jtree).ravel_stacked(stacked, jnp.bfloat16), np.float32)
    spec = make_flat_spec(abstract_params(c))
    ttree = jax.tree.map(torch.from_numpy, stacked)
    got = spec.ravel_stacked(ttree, torch.bfloat16).float().numpy()
    assert np.array_equal(got, want)


def test_unravel_round_trips_as_views():
    _, c = _configs("smoke")
    spec = make_flat_spec(abstract_params(c))
    flat = torch.from_numpy(np.random.default_rng(1).standard_normal(spec.padded_size)
                            .astype(np.float32))
    flat[spec.size:] = 0
    params = params_from_stacked(spec.unravel(flat), c)
    assert len(params["layers"]) == c.num_layers
    assert torch.equal(spec.ravel(stack_params(params)), flat)
    # the layer leaves are views: a write to one lands in the flat vector
    wq = params["layers"][1]["attn"]["wq"]["kernel"]
    wq.fill_(7.0)
    off = spec.offsets[spec.paths.index(("stack", "groups", 0, "attn", "wq", "kernel"))]
    per = wq.numel()
    assert torch.equal(flat[off + per:off + 2 * per], torch.full((per,), 7.0))
    # a bf16 cast on unravel restores the dtype of a bf16 spec
    bspec = dataclasses.replace(spec, dtypes=(torch.bfloat16,) * len(spec.dtypes))
    assert all(x.dtype == torch.bfloat16 for x in tree_flatten(bspec.unravel(flat))[0])


def test_tree_flatten_follows_jax_order():
    tree = {"b": [{"z": 1, "a": 2}, None, 3], "a": {"y": 4}, "c": None}
    leaves, paths = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [4, 2, 1, 3]
    assert paths[1] == ("b", 0, "a") and paths[3] == ("b", 2)
    full = {"b": [{"z": 1, "a": 2}, 3], "a": {"y": 4}}
    assert tree_unflatten(*reversed(tree_flatten(full))) == full
    assert PAD_MULTIPLE == 128
