"""`validate` at dp 2 against gill_tpu's one-process validate
(tests/test_torch_train_cli.py's case): each rank runs its contiguous
half of every batch, the eval step's metrics are the global batch's, and
the visual and text embeddings and the caption tokens are gathered over
"data", so retrieval top-1/5 and BLEU cover the whole set on both ranks.
Scalars within test_torch_train_cli.py's tolerance, rtol 1e-4 / atol
1e-5."""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from gill_tpu.config import TrainConfig as JTrainConfig
from gill_tpu.tokenizer import GPT2BPETokenizer as JTok
from gill_tpu.train import validate as jvalidate

import torch_dist_cases as cases
from test_torch_dist_train import CORE_KW
from test_torch_train_step import TC, make_batch, make_cores


def test_validate_at_dp2_matches_gill_tpu(tmp_path):
    class Writer:
        def __init__(self):
            self.scalars = {}

        def add_scalar(self, k, v, step):
            self.scalars[k] = (float(v), step)

        def add_image(self, *a, **k):
            pass

    jc, _ = make_cores()
    p = cases.make_params(CORE_KW, 0)
    batches = [make_batch(b=4, seed=7), make_batch(b=4, seed=8)]
    prefix = np.array([10, 11, 12], np.int32)
    w = Writer()
    with redirect_stdout(io.StringIO()):
        want = jvalidate.validate(
            jc, JTrainConfig(**TC),
            jax.tree_util.tree_map(np.asarray, p["adapters"]),
            {"lm": p["lm"], "vision": p["vision"]},
            [dict(b) for b in batches], JTok.tiny(), epoch=2, writer=w,
            prefix_ids=prefix)
    res = cases.run("validate_dp", 2, tmp_path, core_kw=CORE_KW, tc_kw=TC,
                    seed=0, batches=batches, prefix=prefix)
    for out in res:
        assert out["top1"] == pytest.approx(want)
        assert set(out["scalars"]) == set(w.scalars)
        for k, (v, step) in w.scalars.items():
            assert out["scalars"][k][1] == step == 3
            np.testing.assert_allclose(out["scalars"][k][0], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
