"""Data- and tensor-parallel training of the port against gill_tpu's
global-batch step (tests/test_torch_train_step.py's tiny shapes).

gill_tpu's `make_train_step` runs on one global batch of 8 sharded over a
(2, 1) mesh of CPU devices; the port runs the same step on gloo groups of
CPU processes at mesh (2, 1), (1, 2) and (2, 2), each data rank on its 4
rows. Two steps (concat off, then on): the loss, every metric and the
adapters after each step within 1e-5 (rtol and atol), and the adapters
bit for bit equal across ranks.

At dp 2 the same rank group also packs a global batch of 6 (3 rows a
rank, so pair (2, 3) spans the ranks): the ranks pass the boundary row
and pack 4 and 2 rows, and the loss, every metric and the adapter
gradients are held to gill_tpu's concat step on the global batch within
1e-5.

The batch is split so the two data ranks hold different counts of valid
caption tokens: the global CE is a sum over the global batch's valid
tokens over their global count, and a mean of the two ranks' own means
(DDP's per-rank loss) differs from it by more than the tolerance, which
this test checks too, so a per-rank mean would fail it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gill_tpu.config import TrainConfig as JTrainConfig
from gill_tpu.parallel import create_mesh as jmesh
from gill_tpu.parallel import param_shardings
from gill_tpu.parallel.partition import batch_sharding, replicated
from gill_tpu.train import trainer as jtrainer

import torch_dist_cases as cases
from gill_tpu_torch.train import trainer as ttrainer
from test_torch_train_step import (OPT_TINY, TC, VIS_TINY, _flat,
                                   make_batch, make_cores)

TOL = 1e-5
CONCAT = (False, True)
CORE_KW = {"opt": OPT_TINY, "vis": VIS_TINY,
           "cfg": dict(n_visual_tokens=2, num_tokens=4, num_clip_tokens=6,
                       ret_emb_dim=8, gen_emb_dim=12),
           "ids": dict(vocab_len=69, img_start=65, pad_token_id=1,
                       bos_token_id=2)}


@pytest.fixture(scope="module")
def ref():
    """gill_tpu's two steps on the global batch under a (2, 1) mesh."""
    jc, _ = make_cores()
    params = cases.make_params(CORE_KW, 0)
    batch = make_batch(b=8, seed=3)
    mesh = jmesh(2, 1, devices=jax.devices()[:2])
    frozen = {"lm": params["lm"], "vision": params["vision"]}
    frozen = jax.device_put(frozen, param_shardings(mesh, frozen))
    tcj = JTrainConfig(**TC)
    state = jtrainer.init_state(jc, tcj, jax.tree_util.tree_map(
        jnp.asarray, params["adapters"]))
    state = jax.device_put(state, jax.tree_util.tree_map(
        lambda _: replicated(mesh), state,
        is_leaf=lambda x: hasattr(x, "shape")))
    jb = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
          for k, v in batch.items()}
    step = jtrainer.make_train_step(jc, tcj)
    # the concat step's loss and adapter gradients on a global batch of 6
    odd = make_batch(b=6, seed=5)
    adapters = jax.tree_util.tree_map(jnp.asarray, params["adapters"])

    def loss_fn(a):
        return jtrainer.compute_losses(jc, {**frozen, "adapters": a},
                                       ob, tcj, True)

    ob = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
          for k, v in odd.items()}
    (_, om), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        adapters)
    om = {k: np.asarray(v, np.float32) for k, v in jax.device_get(om).items()
          if k != "_viz"}
    runs = []
    for concat in CONCAT:
        state, m = step(state, frozen, jb, concat=concat)
        m = jax.device_get(m)
        runs.append(({k: np.asarray(v, np.float32) for k, v in m.items()
                      if k != "_viz"}, _flat(state.adapters)))
    return {"params": params, "batch": batch, "runs": runs, "jc": jc,
            "odd_batch": odd, "odd": (om, _flat(grads))}


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_train_steps_match_gill_tpu_global_batch(ref, tmp_path, dp, tp):
    lens = ref["batch"]["ret_len"]
    assert lens[:4].sum() != lens[4:].sum()   # ragged valid-token counts
    res = cases.run("train_steps", dp * tp, tmp_path, core_kw=CORE_KW,
                    tc_kw=TC, seed=0, batch=ref["batch"],
                    concat_seq=CONCAT, dp=dp, tp=tp,
                    odd_batch=ref["odd_batch"] if dp == 2 else None)
    for r, out in enumerate(res):
        assert out["adapters_equal_across_ranks"]
        for i, ((gm, ga), (wm, wa)) in enumerate(zip(out["runs"],
                                                     ref["runs"])):
            assert set(gm) == set(wm), (sorted(gm), sorted(wm))
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL,
                                           err_msg=f"step {i} {k}")
            if r:
                continue      # rank 0's adapters stand for every rank's
            ga = _flat(ga)
            assert set(ga) == set(wa)
            for k in wa:
                np.testing.assert_allclose(ga[k], wa[k], rtol=TOL, atol=TOL,
                                           err_msg=f"step {i} {k}")
    if dp == 2:
        # the packed batch of 6: ranks hold 4 and 2 rows, each rank's
        # metrics are the global step's, the summed gradients gill_tpu's
        assert ttrainer.pair_counts(3, 2) == [4, 2]
        wm, wg = ref["odd"]
        for r in range(dp * tp):
            gm, gg = res[r]["odd"]
            assert set(gm) == set(wm), (sorted(gm), sorted(wm))
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL,
                                           err_msg=f"packed {k}")
            gg = _flat(gg)
            assert set(gg) == set(wg)
            for k in wg:
                np.testing.assert_allclose(gg[k], wg[k], rtol=TOL, atol=TOL,
                                           err_msg=f"packed grad {k}")
        # the first step's caption CE (before the update) is the global
        # mean; the mean of the data ranks' own means is not
        cap = float(ref["runs"][0][0]["cap_ce"])
        own = [res[r]["own_cap_ce"] for r in range(0, dp * tp, tp)]
        assert abs(np.mean(own) - cap) > 10 * TOL, (own, cap)
