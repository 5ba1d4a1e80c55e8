"""The port's GILL training forward against gill_tpu's (tests/test_gill_forward.py's
tiny shapes): label masks, the packing split points, pair packing, every
mode with and without concat_captions and a prompt prefix, summed tap
mappers, the [IMG]-row renorm and `GILL.__call__`. The parameters are made
with the port's fast torch init and handed to gill_tpu as numpy
(weights/from_jax.py `tree_to_numpy`); the port takes gill_tpu's tree back
through `gill_params_from_jax`. gill_tpu's forwards are jitted once per
configuration. Inputs are made from seeds with numpy. Tolerance (fp32):
1e-5 relative to each output's scale (the same products in another
summation order over two layers)."""

import jax
import numpy as np
import pytest
import torch

from gill_tpu.config import CLIPVisionConfig, GILLConfig, OPTConfig
from gill_tpu.models.gill import GILLCore as JCore
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.gill import IGNORE, GILLCore as TCore
from gill_tpu_torch.nn.core import Init, tree_leaves
from gill_tpu_torch.weights import from_jax

OPT_TINY = dict(vocab_size=64, hidden_size=16, ffn_dim=32, num_layers=2,
                num_heads=2, word_embed_proj_dim=16, max_positions=64)
VIS_TINY = dict(hidden_size=16, intermediate_size=32, num_layers=1,
                num_heads=2, image_size=16, patch_size=8)
NUM_TOKENS = 4
VOCAB_LEN = 64 + 1 + NUM_TOKENS      # base + <|image|> + [IMG0..3]
IMG_START = 65
PAD, BOS = 1, 2
PREFIX = np.array([10, 11, 12], np.int32)


def make_cores(taps=(-1,)):
    kw = dict(n_visual_tokens=2, num_tokens=NUM_TOKENS, num_clip_tokens=6,
              ret_emb_dim=8, gen_emb_dim=12, text_emb_layers=taps)
    common = dict(vocab_len=VOCAB_LEN, img_start=IMG_START,
                  pad_token_id=PAD, bos_token_id=BOS)
    jc = JCore(cfg=GILLConfig(**kw), opt_cfg=OPTConfig(**OPT_TINY),
               vis_cfg=CLIPVisionConfig(**VIS_TINY), **common)
    tc = TCore(cfg=tcfg.GILLConfig(**kw), opt_cfg=tcfg.OPTConfig(**OPT_TINY),
               vis_cfg=tcfg.CLIPVisionConfig(**VIS_TINY), **common)
    return jc, tc


def _setup(taps):
    jc, tc = make_cores(taps)
    jp = from_jax.tree_to_numpy(
        tc.init_params(Init(torch.Generator().manual_seed(0), "cpu")))
    return jc, tc, jp, from_jax.gill_params_from_jax(jp)


_JIT = {}


def _jax_forward(jc, mode, concat, prefix):
    key = (id(jc), mode, concat, prefix)
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda p, px, t, n, pre: jc.forward(
            p, px, t, n, mode=mode, concat_captions=concat,
            prefix_ids=pre if prefix else None))
    return _JIT[key]


@pytest.fixture(scope="module")
def cores():
    return _setup((-1,))


@pytest.fixture(scope="module")
def cores_two_taps():
    return _setup((-1, 1))


def make_batch(b=4, t=12, seed=0):
    """Rows BOS + words + [IMG0..3] + pads, as the dataset writes them."""
    rng = np.random.RandomState(seed)
    tokens = np.full((b, t), PAD, np.int32)
    lens = []
    for i in range(b):
        n_words = rng.randint(1, t - NUM_TOKENS - 1)
        row = [BOS] + list(rng.randint(4, 60, n_words)) + list(
            range(IMG_START, IMG_START + NUM_TOKENS))
        tokens[i, :len(row)] = row
        lens.append(len(row))
    return {"pixels": rng.randn(b, 16, 16, 3).astype(np.float32),
            "tokens": tokens, "lens": np.array(lens, np.int32)}


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol)


def _forward_both(jc, tc, jp, tp, batch, mode, concat=False, prefix=False):
    want = _jax_forward(jc, mode, concat, prefix)(
        jp, batch["pixels"], batch["tokens"], batch["lens"], PREFIX)
    got = tc.forward(tp, torch.from_numpy(batch["pixels"]),
                     torch.from_numpy(batch["tokens"]),
                     torch.from_numpy(batch["lens"]), mode=mode,
                     concat_captions=concat,
                     prefix_ids=torch.from_numpy(PREFIX) if prefix else None)
    return got, want


def _compare(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if k == "full_labels":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k], want[k])


@pytest.mark.parametrize("mode", ["captioning", "retrieval", "generation"])
def test_mask_labels_and_first_pad_idx_match(cores, mode):
    jc, tc, _, _ = cores
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, VOCAB_LEN, (6, 10)).astype(np.int32)
    tokens[0, 4] = PAD
    tokens[1, 2] = IMG_START
    tokens[2, 5] = IMG_START + 2
    tokens[3] = 7                      # no trigger at all
    t = torch.from_numpy(tokens).long()
    np.testing.assert_array_equal(tc.mask_labels(t, mode).numpy(),
                                  np.asarray(jc.mask_labels(tokens, mode)))
    np.testing.assert_array_equal(tc.first_pad_idx(t, mode).numpy(),
                                  np.asarray(jc.first_pad_idx(tokens, mode)))


def test_mask_labels_trigger_rules(cores):
    _, tc, _, _ = cores
    t = torch.tensor([[BOS, 10, IMG_START, IMG_START + 1, PAD, 7]])
    assert tc.mask_labels(t, "captioning").tolist() == \
        [[BOS, 10, IGNORE, IGNORE, IGNORE, IGNORE]]
    assert tc.mask_labels(t, "retrieval").tolist() == \
        [[BOS, 10, IMG_START, IGNORE, IGNORE, IGNORE]]


@pytest.mark.parametrize("bos_pos", [0, 2])
def test_pack_pairs_matches(cores, bos_pos):
    jc, tc, _, _ = cores
    rng = np.random.RandomState(bos_pos)
    b, t, d = 6, 9, 5
    embs = rng.randn(b, t, d).astype(np.float32)
    labels = rng.randint(0, 50, (b, t)).astype(np.int32)
    valid = rng.randint(bos_pos + 2, t + 1, b).astype(np.int32)
    last = np.minimum(valid, t - 1) - 1
    want = jc.pack_pairs(embs, labels, valid, bos_pos, last)
    got = tc.pack_pairs(torch.from_numpy(embs), torch.from_numpy(labels),
                        torch.from_numpy(valid).long(), bos_pos,
                        torch.from_numpy(last).long())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    with pytest.raises(ValueError):
        tc.pack_pairs(torch.from_numpy(embs[:5]), torch.from_numpy(labels[:5]),
                      torch.from_numpy(valid[:5]).long(), bos_pos,
                      torch.from_numpy(last[:5]).long())


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("mode", ["captioning", "retrieval", "generation"])
def test_forward_matches_gill_tpu(cores, mode, concat, prefix):
    jc, tc, jp, tp = cores
    got, want = _forward_both(jc, tc, jp, tp, make_batch(), mode, concat,
                              prefix)
    _compare(got, want)
    b = 2 if concat else 4
    if mode != "captioning":
        assert got["last_embedding"].shape[0] == 4     # B*P sub-examples
    assert got["logits"].shape[0] == b


@pytest.mark.parametrize("mode", ["retrieval", "generation"])
def test_forward_sums_tap_mappers_like_gill_tpu(cores_two_taps, mode):
    jc, tc, jp, tp = cores_two_taps
    assert "ret_fc_1" in tp["adapters"] and "gen_fc_1" in tp["adapters"]
    got, want = _forward_both(jc, tc, jp, tp, make_batch(seed=1), mode,
                              concat=True)
    _compare(got, want)


def test_forward_remat_equals_plain(cores):
    _, tc, _, tp = cores
    batch = make_batch(seed=2)
    args = (tp, torch.from_numpy(batch["pixels"]),
            torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["lens"]))
    a = tc.forward(*args, mode="generation")
    with torch.enable_grad():
        b = tc.forward(*args, mode="generation", remat=True)
    assert torch.equal(a["logits"], b["logits"].detach())
    assert torch.equal(a["last_embedding"], b["last_embedding"].detach())


def test_renorm_img_embeddings_matches(cores):
    jc, tc, jp, tp = cores
    want = jc.renorm_img_embeddings(jp)["adapters"]["img_embeddings"]
    out = tc.renorm_img_embeddings(tp)
    _close(out["adapters"]["img_embeddings"], want)
    assert out["adapters"]["visual_fc"] is tp["adapters"]["visual_fc"]
    assert out["lm"] is tp["lm"]
    frozen = tp["lm"]["embed_tokens"]["weight"][:VOCAB_LEN - NUM_TOKENS]
    target = torch.linalg.vector_norm(frozen, dim=1).mean()
    norms = torch.linalg.vector_norm(out["adapters"]["img_embeddings"], dim=1)
    torch.testing.assert_close(norms, target.expand(NUM_TOKENS), rtol=1e-5,
                               atol=0)


class _PrefixTokenizer:
    """Encodes any prompt as PREFIX (the tiny LM's vocabulary has 69
    entries, no byte-level tokenizer fits it)."""

    def encode(self, text, add_special_tokens=True):
        return PREFIX.tolist()


def test_gill_call_dispatches_forward_and_generate(cores):
    from gill_tpu_torch.api import GILL

    jc, tc, jp, tp = cores
    model = GILL(tc, tp, _PrefixTokenizer(), device="cpu")
    batch = make_batch(seed=4)
    px, tok, ln = (torch.from_numpy(batch[k])
                   for k in ("pixels", "tokens", "lens"))
    got = model(px, tok, ln, mode="retrieval", concat_captions=True,
                input_prefix="A picture of")
    want = _jax_forward(jc, "retrieval", True, True)(
        jp, batch["pixels"], batch["tokens"], batch["lens"], PREFIX)
    _compare(got, want)

    embs = tc.embed_tokens(tp, tok[:2, :5])
    out = model(embs, generate=True, num_words=4, temperature=0.0)
    ref = tc.generate(tp, embs, num_words=4, temperature=0.0)
    for k in ("tokens", "hidden", "valid"):
        assert torch.equal(out[k], ref[k]), k


def test_init_params_tree_matches_gill_tpu(cores):
    """The port's init gives gill_tpu's tree: every key and shape of
    `GILLCore.init_params` (traced for shapes only, not run)."""
    jc, tc, _, _ = cores
    tp = tc.init_params(Init(torch.Generator().manual_seed(1), "cpu"))
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jc.init_params, jax.random.PRNGKey(0)))[0]
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(
               from_jax.tree_to_numpy(tp))[0]}
    assert set(got) == {jax.tree_util.keystr(k) for k, _ in want}
    for k, v in want:
        assert got[jax.tree_util.keystr(k)].shape == v.shape, k
    assert all(not x.requires_grad for x in tree_leaves(tp))
