"""The port's train step in gill_tpu's other modes, at
tests/test_torch_train_step.py's tiny shapes and tolerance (rtol 1e-4 /
atol 1e-5): gradient accumulation 2 against gill_tpu's `optax.MultiSteps`
step, the W8 frozen LM against gill_tpu's W8 step (tests/test_train_step.py
:153-184), and the optimizer state through a checkpoint and back. Each
gill_tpu configuration is compiled and run once."""

import jax
import numpy as np
import pytest
import torch

from gill_tpu.config import TrainConfig as JTrainConfig
from gill_tpu.models import opt as jopt
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.nn.core import tree_leaves
from gill_tpu_torch.train import trainer as ttrainer
from gill_tpu_torch.weights import from_jax
from test_torch_train_step import (STEPS, TC, _assert_runs_match, _flat,  # noqa: F401
                                   run_jax, run_torch, setup)


def test_grad_accumulation_matches_optax_multisteps(setup):
    want = run_jax(setup, JTrainConfig(**TC, grad_accumulation_steps=2),
                   setup["frozen_j"], [False] * 4, steps=4)
    tct = tcfg.TrainConfig(**TC, grad_accumulation_steps=2)
    got = run_torch(setup, tct, setup["frozen_t"], [False] * 4, steps=4)
    _assert_runs_match(got, want)
    # the first mini-step applies nothing but the renorm; the first
    # applied update (step 2) takes lr(0) = 0 under warmup, the second
    # (step 4) moves the adapters
    start = _flat(from_jax.adapters_from_jax(setup["params"]["adapters"]))
    for k, v in got[0][1].items():
        if "img_embeddings" not in k:
            np.testing.assert_array_equal(v, start[k], err_msg=k)
    assert [float(m["lr"]) for m, _ in got] == pytest.approx(
        [0.0, 1e-3, 2e-3, 2e-3])
    assert any(not np.array_equal(v, start[k]) for k, v in got[3][1].items()
               if "img_embeddings" not in k)


def test_w8_frozen_lm_step_matches_gill_tpu(setup):
    s = setup
    w8 = {"lm": jopt.quantize_params_w8(s["params"]["lm"]),
          "vision": s["frozen_j"]["vision"]}
    want = run_jax(s, JTrainConfig(**TC), w8, [False] * STEPS)
    frozen = {"lm": from_jax.opt_from_jax(jax.device_get(w8["lm"])),
              "vision": s["frozen_t"]["vision"]}
    assert frozen["lm"]["layers"]["fc1"]["w8"].dtype == torch.int8
    got = run_torch(s, tcfg.TrainConfig(**TC), frozen, [False] * STEPS)
    _assert_runs_match(got, want)
    plain = run_torch(s, tcfg.TrainConfig(**TC), s["frozen_t"],
                      [False] * STEPS)
    # the quantized LM tracks the fp32 one (tests/test_train_step.py:181)
    np.testing.assert_allclose([m["loss"] for m, _ in got],
                               [m["loss"] for m, _ in plain], rtol=0.05)


def test_checkpoint_state_round_trip(setup, tmp_path):
    from gill_tpu_torch.utils import ckpt

    s = setup
    tct = tcfg.TrainConfig(**TC, grad_accumulation_steps=2)
    state = ttrainer.init_state(tct, from_jax.adapters_from_jax(
        s["params"]["adapters"]))
    step = ttrainer.make_train_step(s["tc"], tct)
    batch = ttrainer.put_batch(s["batch"], "cpu")
    state, _ = step(state, s["frozen_t"], batch)
    ckpt.save_checkpoint(ttrainer.state_tree(state), str(tmp_path),
                         step=state.step)
    tree, meta = ckpt.load_checkpoint(str(tmp_path))
    back = ttrainer.state_from_tree(tree, meta["step"], "cpu")
    assert back.step == 1 and back.opt_state["mini_step"] == 1
    assert all(x.requires_grad for x in tree_leaves(back.adapters))
    # the resumed state takes the same next step as the live one
    a, ma = step(state, s["frozen_t"], batch)
    b, mb = step(back, s["frozen_t"], batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(tree_leaves(a.adapters), tree_leaves(b.adapters)):
        assert torch.equal(x, y)
