"""gill_tpu's last public helpers in the port, each against its gill_tpu
counterpart on the same inputs (nn/core.py `param_count`,
`tree_size_bytes`, `cast_tree`; utils/image.py `get_pixel_values`,
`pad_to_square`; train/validate.py `generate_captions`), utils/profiling
(`trace`, `StepTimer`), and `GillDecodeEngine.warmup`: the tokens and
[IMG] taps served after a warm-up are exactly those served without one.
"""

import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from gill_tpu.nn import core as jnn
from gill_tpu.tokenizer import GPT2BPETokenizer as JTokenizer
from gill_tpu.train.validate import generate_captions as j_captions
from gill_tpu.utils import image as jimage
from gill_tpu.utils import profiling as jprofiling
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.nn import core as tnn
from gill_tpu_torch.serve.gill_engine import GillDecodeEngine, GillServeRequest
from gill_tpu_torch.tokenizer import GPT2BPETokenizer
from gill_tpu_torch.train.validate import generate_captions
from gill_tpu_torch.utils import image as timage
from gill_tpu_torch.utils import profiling
from gill_tpu_torch.weights.from_jax import (gill_params_from_jax,
                                             tree_to_numpy)

from test_gill_forward import make_core


def _tcore(core):
    return GILLCore(
        cfg=tcfg.GILLConfig(**core.cfg.__dict__),
        opt_cfg=tcfg.OPTConfig(**core.opt_cfg.__dict__),
        vis_cfg=tcfg.CLIPVisionConfig(**core.vis_cfg.__dict__),
        vocab_len=core.vocab_len, img_start=core.img_start,
        pad_token_id=core.pad_token_id, bos_token_id=core.bos_token_id)


def _params(core, seed):
    """The tiny GILL's parameters from the port's init, as numpy in
    gill_tpu's layout (for both packages; faster than JAX's eager init)."""
    return tree_to_numpy(_tcore(core).init_params(
        tnn.Init(torch.Generator().manual_seed(seed), "cpu")))


def _trees():
    """One tree in both packages: fp32, bf16 and int8 leaves, nested."""
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    c = rng.randint(-5, 5, size=(2, 6)).astype(np.int8)
    j = {"a": jnp.asarray(a), "n": {"b": jnp.asarray(b, jnp.bfloat16),
                                    "c": jnp.asarray(c)}}
    t = {"a": torch.from_numpy(a), "n": {"b": torch.from_numpy(b).to(
        torch.bfloat16), "c": torch.from_numpy(c)}}
    return j, t


def test_param_count_and_tree_size_match_gill_tpu():
    j, t = _trees()
    assert tnn.param_count(t) == jnn.param_count(j) == 12 + 5 + 12
    assert tnn.tree_size_bytes(t) == jnn.tree_size_bytes(j) == \
        12 * 4 + 5 * 2 + 12


def test_cast_tree_matches_gill_tpu():
    j, t = _trees()
    jc, tc = jnn.cast_tree(j, jnp.bfloat16), tnn.cast_tree(t, torch.bfloat16)
    assert tc["a"].dtype == torch.bfloat16 and tc["n"]["c"].dtype == \
        torch.int8
    assert jc["a"].dtype == jnp.bfloat16 and jc["n"]["c"].dtype == jnp.int8
    np.testing.assert_array_equal(tc["a"].float().numpy(),
                                  np.asarray(jc["a"], np.float32))
    np.testing.assert_array_equal(tc["n"]["c"].numpy(),
                                  np.asarray(jc["n"]["c"]))
    back = tnn.cast_tree(tc, torch.float32)
    assert back["n"]["b"].dtype == torch.float32
    assert back["n"]["c"] is tc["n"]["c"]        # integers untouched


def test_image_helpers_match_gill_tpu():
    rng = np.random.RandomState(1)
    img = Image.fromarray(rng.randint(0, 256, (37, 61, 3), dtype=np.uint8))
    sq_t, sq_j = timage.pad_to_square(img), jimage.pad_to_square(img)
    assert sq_t.size == sq_j.size == (61, 61)
    np.testing.assert_array_equal(np.asarray(sq_t), np.asarray(sq_j))
    tall = timage.pad_to_square(img.transpose(Image.Transpose.TRANSPOSE))
    np.testing.assert_array_equal(
        np.asarray(tall), np.asarray(jimage.pad_to_square(
            img.transpose(Image.Transpose.TRANSPOSE))))
    np.testing.assert_array_equal(timage.get_pixel_values(img, 32),
                                  jimage.get_pixel_values(img, 32))


def test_generate_captions_matches_gill_tpu():
    core = make_core()
    jp = _params(core, 0)
    pixels = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)
    prefix = np.array([10, 11, 12], np.int32)
    want = j_captions(core, jp, jnp.asarray(pixels), jnp.asarray(prefix),
                      JTokenizer.tiny(), num_words=6)
    got = generate_captions(_tcore(core), gill_params_from_jax(jp),
                            torch.from_numpy(pixels),
                            torch.from_numpy(prefix).long(),
                            GPT2BPETokenizer.tiny(), num_words=6)
    assert got == want and len(got) == 2


def test_profiling_trace_and_step_timer(tmp_path):
    with profiling.trace(str(tmp_path / "t"), cuda=False) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any("matmul" in e.key or "dot" in e.key
               for e in prof.key_averages())
    for mod in (profiling, jprofiling):
        timer = mod.StepTimer(alpha=0.5)
        timer.start()
        dt = timer.stop()
        assert dt >= 0 and timer.ema == dt
        timer.start()
        dt2 = timer.stop()
        assert timer.ema == 0.5 * dt + 0.5 * dt2


def test_gill_engine_warmup_is_inert():
    """Warm-up runs every (bucket, wave) prefill with its rows dropped and
    one chunk per read window; then a run serves exactly what a cold
    engine serves, [IMG] runs and taps included."""
    core = make_core()
    tcore = _tcore(core)
    params = gill_params_from_jax(_params(core, 3))
    rng = np.random.RandomState(4)
    reqs = [dict(uid=u, embs=(rng.randn(int(rng.randint(2, 12)), 16) * 0.02)
                 .astype(np.float32), num_words=int(rng.randint(3, 8)),
                 img_scale=100.0 if u % 2 == 0 else 1.0) for u in range(5)]
    kw = dict(slots=3, max_seq=64, chunk=3, prefill_buckets=(8, 16),
              kv_dtype=torch.float32, kv_read_buckets=(16, 32))

    def serve(warm):
        eng = GillDecodeEngine(tcore, params, **kw)
        if warm:
            eng.warmup()
            assert eng.stats["prefills"] == 0      # nothing was admitted
        return eng.run([GillServeRequest(**r) for r in reqs])

    cold, warm = serve(False), serve(True)
    assert set(warm) == set(cold)
    for u in cold:
        assert warm[u]["tokens"] == cold[u]["tokens"], u
        np.testing.assert_array_equal(warm[u]["img_runs"],
                                      cold[u]["img_runs"])
    assert any(core.img_start in r["tokens"] for r in cold.values())
