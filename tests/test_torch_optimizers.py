"""CAME and 8-bit AdamW of the port (training/came.py, training/adam8bit.py)
against the JAX package's, through make_optimizer with a trainable filter
and the dual learning rate, over five updates on the same seeded numpy
gradients (step 3's are 20x, so the clip triggers).

Tolerances: updates and parameters within UPDATE_TOL (float32 formulas
in another order); the int8 blocks of the 8-bit state equal or one
quantum apart (a value on a rounding boundary may round either way), the
float32 scales within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easyanimate_tpu.training import adam8bit as jadam8bit
from easyanimate_tpu.training import came as jcame
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu_torch.training import adam8bit as tadam8bit
from easyanimate_tpu_torch.training import came as tcame
from easyanimate_tpu_torch.training import optim as toptim
from easyanimate_tpu_torch.training import trainer as ttrainer

UPDATE_TOL = 1e-6
# 2-D, 3-D (CAME's leading axis) and 1-D leaves; blocks.attn1.w spans three
# 2048-element blocks, the last one padded
SHAPES = {"blocks.attn1.w": (48, 100), "blocks.attn1.b": (100,),
          "blocks.ff.w": (2, 6, 10), "blocks.ff.b": (10,),
          "norm.scale": (7,)}
CASES = {
    "came": dict(optimizer="came", learning_rate=1e-2, max_grad_norm=1.0,
                 trainable_modules=["attn1"], trainable_modules_low_lr=["ff"],
                 lr_scheduler="linear", lr_warmup_steps=2, max_train_steps=8),
    "adamw8bit": dict(optimizer="adamw8bit", learning_rate=1e-2,
                      weight_decay=0.1, max_grad_norm=1.0,
                      trainable_modules=["attn1"],
                      trainable_modules_low_lr=["ff"]),
    "came_accumulate_2": dict(optimizer="came", learning_rate=1e-2,
                              gradient_accumulation_steps=2),
}


def _nest(flat):
    out = {}
    for name, a in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out


def _get(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


def _find(state, cls):
    """The first `cls` state inside a (nested) optimizer state."""
    if isinstance(state, cls):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _find(s, cls)
            if found is not None:
                return found
    inner = getattr(state, "inner_opt_state", None) or getattr(state, "inner", None)
    return None if inner is None else _find(inner, cls)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(rng, case):
    kw = CASES[case]
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    jparams = _nest(params)
    jtx = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw), jparams)
    jstate = jtx.init(jparams)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ttx = ttrainer.make_optimizer(ttrainer.TrainConfig(**kw), tparams)
    tstate = ttx.init(tparams)
    for i in range(5):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 * (20 if i == 3 else 0.3) for n, s in SHAPES.items()}
        jupd, jstate = jtx.update(_nest(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = ttx.update({n: torch.from_numpy(g)
                                   for n, g in grads.items()}, tstate, tparams)
        for name, u in tupd.items():
            np.testing.assert_allclose(u.numpy(), _get(jupd, name),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL)
        toptim.apply_updates(tparams, tupd)
        for name, p in tparams.items():
            np.testing.assert_allclose(p.numpy(), _get(jparams, name),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL)
        if kw["optimizer"] == "adamw8bit":
            js = _find(jstate, jadam8bit.Adam8bitState)
            ts = _find(tstate, tadam8bit.Adam8bitState)
            assert ts.count == int(js.count) == i + 1
            for q, scale in (("m_q", "m_scale"), ("v_q", "v_scale")):
                for name in SHAPES:
                    got = getattr(ts, q)[name]
                    assert got.dtype == torch.int8
                    diff = np.abs(got.numpy().astype(np.int32)
                                  - _get(getattr(js, q), name).astype(np.int32))
                    assert diff.max() <= 1, (q, name)
                    np.testing.assert_allclose(getattr(ts, scale)[name].numpy(),
                                               _get(getattr(js, scale), name),
                                               rtol=1e-6, atol=0)
    # the frozen leaf never moves (not even by weight decay)
    if kw.get("trainable_modules"):
        assert torch.equal(tparams["norm.scale"],
                           torch.from_numpy(params["norm.scale"]))


def test_came_factors_and_8bit_blocks_have_the_documented_shapes():
    params = {n: torch.zeros(s) for n, s in SHAPES.items()}
    st = tcame.came(1.0).init(params)
    assert st.v["blocks.ff.w"].row.shape == (2, 6)
    assert st.v["blocks.ff.w"].col.shape == (2, 10)
    assert st.v["blocks.ff.b"].full.shape == (10,)
    st8 = tadam8bit.scale_by_adam8bit().init(params)
    assert st8.m_q["blocks.attn1.w"].shape == (3, 2048)
    assert st8.v_scale["blocks.attn1.w"].shape == (3,)
    jst = jcame.came(1.0).init(_nest({n: np.zeros(s, np.float32)
                                      for n, s in SHAPES.items()}))
    assert jst.v["blocks"]["ff"]["w"].row.shape == (2, 6)
