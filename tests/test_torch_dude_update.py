"""The port's fused DuDe round (K1) against the reference's Pallas kernel.

On the CPU ``repro_torch.kernels.ops.dude_round_apply`` runs K1's plain
version; it is held against ``dude_round_apply_pallas`` in interpret mode
over the sweep of ``tests/test_kernels.py`` x f32/bf16 buffers x the four
optimizer kinds, with the same numpy inputs.  The slabs are copies and
round-to-nearest-even latches on both sides, so they must be bitwise
equal; g_bar, w and the slots are f32 arithmetic summed in another order,
held within 1e-5.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` (it has no CPU mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.dude_update import dude_round_apply_pallas  # noqa: E402
from repro_torch.kernels import dude_update, ops  # noqa: E402

TOL = 1e-5
KINDS = {
    "sgd": ("sgd", (("lr", 0.1),)),
    "momentum": ("momentum", (("lr", 0.1), ("beta", 0.9), ("nesterov", False))),
    "nesterov": ("momentum", (("lr", 0.1), ("beta", 0.9), ("nesterov", True))),
    "adamw": ("adamw", (("lr", 1e-3), ("b1", 0.9), ("b2", 0.999), ("eps", 1e-8),
                        ("weight_decay", 0.01))),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, P, opt, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    kind = KINDS[opt][0]
    slots = {"sgd": [], "momentum": [f(P)],
             "adamw": [f(P), rng.random(P).astype(np.float32)]}[kind]
    bc = np.array([1 - 0.9 ** 3, 1 - 0.999 ** 3], np.float32) if kind == "adamw" else None
    return dict(cm=rng.random(n) < 0.5, sm=rng.random(n) < 0.5, fresh=f(n, P),
                gw=f(n, P), infl=f(n, P), g_bar=f(P), w=f(P), slots=slots, bc=bc)


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n,P,tile", [(2, 64, 32), (4, 128, 128), (8, 96, 32)])
@pytest.mark.parametrize("buf", ["f32", "bf16"])
@pytest.mark.parametrize("opt", list(KINDS))
def test_round_apply_matches_pallas(n, P, tile, buf, opt):
    kind, hp = KINDS[opt]
    x = _inputs(n, P, opt, seed=n * P)
    jdt, tdt = DTYPES[buf]
    want = dude_round_apply_pallas(
        jnp.asarray(x["cm"]), jnp.asarray(x["sm"]), jnp.asarray(x["fresh"]),
        jnp.asarray(x["gw"], jdt), jnp.asarray(x["infl"], jdt), jnp.asarray(x["g_bar"]),
        jnp.asarray(x["w"]), tuple(jnp.asarray(s) for s in x["slots"]),
        None if x["bc"] is None else jnp.asarray(x["bc"]),
        kind=kind, hp=hp, tile=tile, interpret=True)
    t = torch.tensor      # copies: the port writes in place, JAX may read the numpy buffers
    got = ops.dude_round_apply(
        t(x["cm"]), t(x["sm"]), t(x["fresh"]), t(x["gw"]).to(tdt), t(x["infl"]).to(tdt),
        t(x["g_bar"]), t(x["w"]), tuple(t(s) for s in x["slots"]),
        None if x["bc"] is None else t(x["bc"]), kind=kind, hp=hp)
    assert ops.dude_round_apply.launches == 0          # the CPU runs the plain version
    for a, b in zip(got[:2], want[:2]):                # slabs: bitwise
        assert a.dtype == tdt
        np.testing.assert_array_equal(a.float().numpy(), _to_np(b))
    for a, b in list(zip(got[2:4], want[2:4])) + list(zip(got[4], want[4])):
        np.testing.assert_allclose(a.numpy(), _to_np(b), atol=TOL, rtol=0)


def test_round_apply_is_in_place_and_casts_a_bf16_fresh_slab():
    """A bf16 fresh slab is latched without a cast pass; committed rows are
    the in-flight values, starting rows the fresh ones, others untouched."""
    x = _inputs(3, 256, "sgd", seed=7)
    t = torch.from_numpy
    cm, sm = torch.tensor([True, False, True]), torch.tensor([False, True, True])
    fresh = t(x["fresh"]).to(torch.bfloat16)
    gw, infl = t(x["gw"]).to(torch.bfloat16), t(x["infl"]).to(torch.bfloat16)
    gw0, infl0 = gw.clone(), infl.clone()
    out = ops.dude_round_apply(cm, sm, fresh, gw, infl, t(x["g_bar"]), t(x["w"]),
                               kind="sgd", hp=(("lr", 0.1),))
    assert out[0] is gw and out[1] is infl
    assert torch.equal(gw[0], infl0[0]) and torch.equal(gw[1], gw0[1])
    assert torch.equal(infl[0], infl0[0]) and torch.equal(infl[1], fresh[1])
    assert torch.equal(gw[2], infl0[2]) and torch.equal(infl[2], fresh[2])


def test_launcher_refuses_cpu_tensors():
    """The CUDA launcher raises on what the kernel does not take, before
    any build: here tensors that are not on a CUDA device."""
    x = _inputs(2, 128, "sgd", seed=1)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA device"):
        dude_update.launch(t(x["cm"]), t(x["sm"]), t(x["fresh"]), t(x["gw"]), t(x["infl"]),
                           t(x["g_bar"]), t(x["w"]), (), None, kind="sgd", hp={"lr": 0.1})
