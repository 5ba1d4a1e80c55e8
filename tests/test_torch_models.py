"""gill_tpu_torch models against their gill_tpu counterparts: the same
numpy-seeded inputs through both, with gill_tpu's random parameters carried
into the port by weights/from_jax.py.

Tolerances (fp32): 1e-5 relative to the output scale where both sides
run the same products in another summation order over a few layers; the
KV-cache decode 2e-4, as test_opt.py holds it. The SD models are in
test_torch_sd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.config import CLIPVisionConfig, OPTConfig
from gill_tpu.models import clip as jclip
from gill_tpu.models import decision as jdecision
from gill_tpu.models import mapper as jmapper
from gill_tpu.models import opt as jopt
from gill_tpu.ops import sampling as jsampling
from gill_tpu.retrieval import RetrievalIndex as JIndex
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models import clip as tclip
from gill_tpu_torch.models import decision as tdecision
from gill_tpu_torch.models import mapper as tmapper
from gill_tpu_torch.models import opt as topt
from gill_tpu_torch.ops import sampling as tsampling
from gill_tpu_torch.retrieval import RetrievalIndex as TIndex
from gill_tpu_torch.weights import from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _np(tree):
    return jax.device_get(tree)


def _close(got, want, rtol, atol=None):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    atol = rtol * max(1.0, float(np.abs(want).max())) if atol is None else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

VIS = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                       num_heads=4, image_size=32, patch_size=8)
TXT = tcfg.CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                          num_layers=2, num_heads=4, max_positions=16,
                          eos_token_id=99)


def test_clip_vision_matches_gill_tpu():
    p = _np(jclip.init_vision(jax.random.PRNGKey(0), VIS))
    px = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = jclip.vision_forward(p, VIS, jnp.asarray(px))
    got = tclip.vision_forward(from_jax.clip_vision_from_jax(p),
                               tcfg.CLIPVisionConfig(**VIS.__dict__),
                               torch.from_numpy(px))
    _close(got["last_hidden"], want["last_hidden"], 1e-5)
    _close(got["pooler_output"], want["pooler_output"], 1e-5)


def test_clip_text_matches_gill_tpu():
    jtxt = jclip.CLIPTextConfig(**TXT.__dict__)
    p = _np(jclip.init_text(jax.random.PRNGKey(1), jtxt))
    ids = np.array([[5, 7, 9, 99, 0, 0], [1, 2, 99, 99, 3, 4]], np.int32)
    want = jclip.text_forward(p, jtxt, jnp.asarray(ids))
    got = tclip.text_forward(from_jax.clip_text_from_jax(p), TXT,
                             torch.from_numpy(ids).long())
    _close(got["last_hidden"], want["last_hidden"], 1e-5)
    _close(got["pooler_output"], want["pooler_output"], 1e-5)


# ---------------------------------------------------------------------------
# OPT
# ---------------------------------------------------------------------------

TINY = OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64, num_layers=2,
                 num_heads=4, word_embed_proj_dim=32, max_positions=64)
PROJ = OPTConfig(vocab_size=96, hidden_size=32, ffn_dim=64, num_layers=2,
                 num_heads=4, word_embed_proj_dim=16, max_positions=64,
                 do_layer_norm_before=False)


@pytest.mark.parametrize("cfg", [TINY, PROJ], ids=["pre_ln", "post_ln_proj"])
def test_opt_forward_matches_gill_tpu(cfg):
    """logits (fp32), last_hidden and the L+1 hidden-state taps, with
    project_in/out and post-LN in the second config."""
    p = _np(jopt.init(jax.random.PRNGKey(2), cfg))
    ids = np.array([[2, 5, 9, 30, 60, 7, 11, 42]])
    want = jopt.forward(p, cfg, jopt.embed_tokens(p, jnp.asarray(ids)),
                        collect_hidden=True)
    tp = from_jax.opt_from_jax(p)
    got = topt.forward(tp, tcfg.OPTConfig(**cfg.__dict__),
                       topt.embed_tokens(tp, torch.from_numpy(ids)),
                       collect_hidden=True)
    assert got["logits"].dtype == torch.float32
    assert got["hidden_states"].shape[0] == cfg.num_layers + 1
    _close(got["logits"], want["logits"], 1e-5)
    _close(got["last_hidden"], want["last_hidden"], 1e-5)
    _close(got["hidden_states"], want["hidden_states"], 1e-5)


def test_opt_kv_cache_decode_matches_full_forward_and_gill_tpu():
    """Prefill 5 tokens, then decode 3 one at a time over the in-place
    cache (test_opt.py::test_kv_cache_decode_matches_full_forward)."""
    p = _np(jopt.init(jax.random.PRNGKey(3), TINY))
    tp = from_jax.opt_from_jax(p)
    tcfg_ = tcfg.OPTConfig(**TINY.__dict__)
    ids = np.array([[2, 5, 9, 30, 100, 7, 11, 42]])
    embs = topt.embed_tokens(tp, torch.from_numpy(ids))
    full = topt.forward(tp, tcfg_, embs)
    cache = topt.init_cache(tcfg_, 1, 16, device="cpu", dtype=torch.float32)
    out = topt.forward(tp, tcfg_, embs[:, :5], cache=cache, cache_pos=0)
    logits = [out["logits"]]
    for i in range(5, 8):
        step = topt.forward(tp, tcfg_, embs[:, i:i + 1], cache=cache,
                            cache_pos=i)
        logits.append(step["logits"])
    cached = torch.cat(logits, dim=1)
    _close(cached, full["logits"].numpy(), 2e-4)

    jembs = jopt.embed_tokens(p, jnp.asarray(ids))
    jcache = jopt.init_cache(TINY, 1, 16, dtype=jnp.float32)
    jout = jopt.forward(p, TINY, jembs[:, :5], cache=jcache, cache_pos=0)
    np.testing.assert_allclose(cache["k"][:, :, :5].numpy(),
                               np.asarray(jout["cache"]["k"])[:, :, :5],
                               atol=1e-5, rtol=1e-5)
    _close(cached, np.asarray(jopt.forward(p, TINY, jembs)["logits"]), 2e-4)


# ---------------------------------------------------------------------------
# mapper, decision, sampling, retrieval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,with_embs", [("linear", False),
                                            ("gill_mapper", False),
                                            ("gill_mapper", True)])
def test_mapper_matches_gill_tpu(mode, with_embs):
    kw = dict(in_dim=16, out_dim=12, num_input_tokens=4,
              num_output_tokens=1 if mode == "linear" else 6, mode=mode,
              hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_layers=2,
              num_decoder_layers=2)
    jc, tc = jmapper.MapperConfig(**kw), tcfg.MapperConfig(**kw)
    p = _np(jmapper.init(jax.random.PRNGKey(4), jc))
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 16).astype(np.float32)
    e = rng.randn(3, 4, 16).astype(np.float32) if with_embs else None
    want = jmapper.apply(p, jc, jnp.asarray(x),
                         None if e is None else jnp.asarray(e))
    got = tmapper.apply(from_jax.tree_from_jax(p), tc, torch.from_numpy(x),
                        None if e is None else torch.from_numpy(e))
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


def test_decision_matches_gill_tpu():
    p = _np(jdecision.init(jax.random.PRNGKey(5), in_dim=16))
    h = np.random.RandomState(5).randn(1, 16).astype(np.float32)
    tp = from_jax.tree_from_jax(p)
    _close(tdecision.apply(tp, torch.from_numpy(h)),
           jdecision.apply(p, jnp.asarray(h)), 1e-6)
    label, probs = tdecision.decide(tp, torch.from_numpy(h))
    jlabel, jprobs = jdecision.decide(p, jnp.asarray(h))
    assert label == jlabel
    np.testing.assert_allclose(probs, jprobs, atol=1e-6)


def test_greedy_sampling_takes_first_max_like_jax():
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0],
                       [-1.0, -5.0, -1.0, -2.0]], np.float32)
    want = np.asarray(jsampling.sample(None, jnp.asarray(logits), 0.0, 1.0))
    got = tsampling.sample(torch.from_numpy(logits), 0.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [0.3, 0.9])
def test_top_p_filter_matches_gill_tpu(top_p):
    logits = np.random.RandomState(6).randn(3, 50).astype(np.float32) * 2
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(logits), top_p))
    got = tsampling.top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_temperature_sampling_stays_in_nucleus():
    logits = torch.from_numpy(
        np.random.RandomState(7).randn(4, 30).astype(np.float32))
    keep = ~torch.isinf(tsampling.top_p_filter(logits / 0.7, 0.5))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampling.sample(logits, 0.7, 0.5, g)
        assert bool(keep[torch.arange(4), tok].all())


def test_retrieval_index_matches_gill_tpu(tmp_path):
    from gill_tpu.retrieval import load_embeddings as jload
    from gill_tpu.retrieval import save_embeddings
    from gill_tpu_torch.retrieval import load_embeddings as tload

    rng = np.random.RandomState(8)
    mat = rng.randn(40, 8).astype(np.float32)
    save_embeddings(str(tmp_path / "cc3m_a.npy"), [f"p{i}" for i in range(40)],
                    mat)
    paths, m = tload(str(tmp_path))
    jpaths, jm = jload(str(tmp_path))
    assert paths == jpaths
    np.testing.assert_array_equal(m, jm)
    ji, ti = JIndex(paths, m, 14.3), TIndex(paths, m, 14.3, device="cpu")
    q = rng.randn(8).astype(np.float32)
    q /= np.linalg.norm(q)
    for seen in ([], [3], [3, 3, 17]):
        js, jidx = ji.topk(q, k=3, seen_idx=seen)
        ts, tidx = ti.topk(torch.from_numpy(q), k=3, seen_idx=seen)
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ti.scores_for(q, [1, 5]),
                               ji.scores_for(q, [1, 5]), rtol=1e-5)


def test_retrieval_index_defaults_to_the_card():
    """RetrievalIndex, a public entry point, puts its matrix on the card
    unless the caller names another device (as load_gill does); the CPU
    tests name the CPU."""
    import inspect

    sig = inspect.signature(TIndex.__init__)
    assert sig.parameters["device"].default == "cuda"
    rng = np.random.RandomState(9)
    idx = TIndex([f"p{i}" for i in range(5)], rng.randn(5, 4), 2.0,
                 device="cpu")
    assert idx.matrix.device.type == "cpu" and idx.n == 5
    np.testing.assert_allclose(
        torch.linalg.vector_norm(idx.matrix, dim=1).numpy(), 2.0, rtol=1e-6)


def test_from_jax_conv_layout():
    """HWIO kernels become OIHW views in channels_last memory; other leaves
    carry over as they are, bf16 kept."""
    w = np.arange(3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 2, 5)
    tree = {"conv": {"w": w, "b": np.ones(5, np.float32)},
            "lin": {"w": jnp.ones((4, 6), jnp.bfloat16)}, "blocks": [{}]}
    out = from_jax.tree_from_jax(_np(tree))
    assert tuple(out["conv"]["w"].shape) == (5, 2, 3, 3)
    assert out["conv"]["w"].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(out["conv"]["w"].permute(2, 3, 1, 0).numpy(),
                                  w)
    assert out["lin"]["w"].dtype == torch.bfloat16
    assert out["blocks"] == [{}]
