"""The valid-prefix decode attention of gill_tpu_torch against gill_tpu: the
kernel's plain version against the Pallas kernel (interpret mode, as
tests/test_decode_attn.py runs it), the dispatcher's predicates, and the
int8-KV `_decode_attention`.

The kernel's split arithmetic (`prefix_decode_attention_split_ref`: per
split partials merged in order, then the own token) is held against the
Pallas kernel too, at 1, 2, 3 and 8 splits, and `decode_plan` to its rules.

Tolerances: fp32 2e-5 (test_decode_attn.py's own bound: fp32 softmax sums
in another order); bf16 outputs one bf16 ulp of the largest output (both
sides round one fp32 value to bf16); the int8-KV decode four bf16 ulps of
the largest output (its PV product runs in bf16 on both sides, and the two
frameworks round the bf16 sum over the cache at different points).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.ops import attention as jattn
from gill_tpu.ops import decode_attn as jda
from gill_tpu_torch.ops import attention as tattn
from gill_tpu_torch.ops import decode_attn as tda

BF16_ULP = 2.0 ** -7


def _inputs(rng, b, s, h, d):
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, 1, h, d), (b, s, h, d), (b, s, h, d), (b, 1, h, d),
             (b, 1, h, d))]


@pytest.mark.parametrize("b,s,h,d", [(3, 256, 4, 64), (2, 512, 8, 80),
                                     (2, 128, 2, 128)])
def test_plain_version_matches_pallas(b, s, h, d):
    q, k, v, k1, v1 = _inputs(np.random.RandomState(0), b, s, h, d)
    lens = np.array([0, s // 3, s], np.int32)[:b]     # parked, mid, full
    scale = 1.0 / np.sqrt(d)
    want = jda.prefix_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lens),
        jnp.asarray(k1), jnp.asarray(v1), scale=scale, interpret=True)
    got = tda.prefix_decode_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(lens),
        torch.from_numpy(k1), torch.from_numpy(v1), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_plain_version_matches_pallas_bf16():
    b, s, h, d = 4, 256, 4, 64
    arrs = _inputs(np.random.RandomState(1), b, s, h, d)
    lens = np.array([1, 17, 255, 256], np.int32)
    j = [jnp.asarray(x, jnp.bfloat16) for x in arrs]
    t = [torch.from_numpy(x).bfloat16() for x in arrs]
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jda.prefix_decode_attention(
        j[0], j[1], j[2], jnp.asarray(lens), j[3], j[4], scale=scale,
        interpret=True).astype(jnp.float32))
    got = tda.prefix_decode_attention(t[0], t[1], t[2],
                                      torch.from_numpy(lens), t[3], t[4],
                                      scale=scale)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - want).max()) \
        <= BF16_ULP * float(np.abs(want).max())


def test_parked_row_returns_own_value():
    """Length 0 is the own token alone: softmax over one logit gives v1."""
    q, k, v, k1, v1 = (torch.from_numpy(x) for x in
                       _inputs(np.random.RandomState(2), 2, 128, 2, 64))
    got = tda.prefix_decode_attention(q, k, v, torch.zeros(2, dtype=torch.int32),
                                      k1, v1, scale=0.125)
    np.testing.assert_allclose(got.numpy(), v1.numpy(), atol=1e-5, rtol=1e-5)


def test_plain_version_reads_strided_windows():
    """The engines pass a read window of a larger pool: a strided view gives
    what its contiguous copy gives, and lengths past the window clip."""
    rng = np.random.RandomState(3)
    pool = torch.from_numpy(rng.randn(2, 3, 96, 2, 128).astype(np.float32))
    k, v = pool[0, :, :64], pool[1, :, :64]
    q, k1, v1 = (torch.from_numpy(rng.randn(3, 1, 2, 128).astype(np.float32))
                 for _ in range(3))
    lens = torch.tensor([5, 64, 90], dtype=torch.int32)
    got = tda.prefix_decode_attention(q, k, v, lens, k1, v1, scale=0.1)
    want = tda.prefix_decode_attention(q, k.contiguous(), v.contiguous(),
                                       lens.clamp(max=64), k1, v1, scale=0.1)
    torch.testing.assert_close(got, want)


def _split_case(splits, dtype, pool=False):
    """(got, want): the split arithmetic and the Pallas kernel (interpret
    mode) on one seeded input, B 4, S 128, H 2, D 128, with a parked row,
    a row ending inside a split, one ending on a split boundary and a full
    row; `pool` reads the cache as a strided window of a larger pool."""
    b, s, h, d = 4, 128, 2, 128
    rng = np.random.RandomState(20 + splits)
    q, k1, v1 = (rng.randn(b, 1, h, d).astype(np.float32) for _ in range(3))
    big = rng.randn(2, b, s + 32 if pool else s, h, d).astype(np.float32)
    rows = tda.split_rows(s, splits)
    lens = np.array([0, rows // 2 + 3, rows if rows < s else s - rows // 4,
                     s], np.int32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jda.prefix_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(big[0, :, :s], jdt),
        jnp.asarray(big[1, :, :s], jdt), jnp.asarray(lens),
        jnp.asarray(k1, jdt), jnp.asarray(v1, jdt), scale=d ** -0.5,
        interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tpool = torch.from_numpy(big).to(tdt)
    k, v = tpool[0, :, :s], tpool[1, :, :s]
    assert k.is_contiguous() != pool
    got = tda.prefix_decode_attention_split_ref(
        torch.from_numpy(q).to(tdt), k, v, torch.from_numpy(lens),
        torch.from_numpy(k1).to(tdt), torch.from_numpy(v1).to(tdt),
        scale=d ** -0.5, splits=splits)
    assert got.dtype == tdt and tuple(got.shape) == (b, 1, h, d)
    return got.float().numpy(), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_arithmetic_matches_pallas(splits, dtype):
    got, want = _split_case(splits, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert float(np.abs(got - want).max()) \
            <= BF16_ULP * float(np.abs(want).max())


@pytest.mark.parametrize("splits", [3, 8])
def test_split_arithmetic_reads_strided_windows(splits):
    got, want = _split_case(splits, "float32", pool=True)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_split_arithmetic_parked_row_is_own_value():
    q, k, v, k1, v1 = (torch.from_numpy(x) for x in
                       _inputs(np.random.RandomState(5), 2, 128, 2, 128))
    got = tda.prefix_decode_attention_split_ref(
        q, k, v, torch.zeros(2, dtype=torch.int32), k1, v1, scale=0.1,
        splits=8)
    assert torch.equal(got, v1)


@pytest.mark.parametrize("b,s,h,d", [
    (16, 256, 32, 128), (16, 512, 32, 128), (8, 256, 32, 128),
    (8, 512, 32, 128), (4, 2048, 32, 128), (1, 64, 32, 128),
    (64, 128, 32, 128), (8, 768, 32, 128), (3, 64, 4, 256), (2, 128, 2, 512),
    (5, 100, 3, 128), (1, 8, 1, 512)])
@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_decode_plan_rules(b, s, h, d, num_sms):
    """At most 8 splits (the portable cluster); the splits' row ranges
    cover [0, S) once, none empty; heads divide H; one ring stage is 16 KB;
    the plan reads no lengths (its arguments are the shape and the card)."""
    plan = tda.decode_plan(b, s, h, d, num_sms)
    assert 1 <= plan.splits <= tda.MAX_SPLITS
    assert plan.rows % 8 == 0 and plan.rows == tda.split_rows(s, plan.splits)
    covered = [r for j in range(plan.splits)
               for r in range(j * plan.rows, min((j + 1) * plan.rows, s))]
    assert covered == list(range(s))
    assert (plan.splits - 1) * plan.rows < s
    assert h % plan.heads == 0 and plan.heads * d <= tda.ROW_ELEMS
    assert plan.tile_rows * plan.heads * d * 4 == tda.STAGE_BYTES
    assert plan.blocks == b * (h // plan.heads) * plan.splits
    assert list(inspect.signature(tda.decode_plan).parameters) == [
        "b", "s", "h", "d", "num_sms"]


@pytest.mark.parametrize("args", [(2, 128, 2, 64), (0, 128, 2, 128),
                                  (2, 0, 2, 128), (70000, 128, 2, 128)])
def test_decode_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        tda.decode_plan(*args)


def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype), jnp.zeros(shape, getattr(
        jnp, str(dtype).split(".")[-1]))


def test_plan_rows_follow_the_pool():
    """K6 plans for the pool a (B, S, H, D) window reads (its batch
    stride over its row stride), so the engines' read window leaves a
    row's splits as they are; any other layout plans for its own S."""
    from gill_tpu_torch.ops.decode_attn import plan_rows

    pool = torch.zeros(2, 3, 512, 4, 128)               # (L, B, S, H, D)
    k, v = pool[0], pool[1]
    assert plan_rows(k, v) == 512
    assert plan_rows(k[:, :256], v[:, :256]) == 512
    assert plan_rows(k[:, :256], v[:, :256].contiguous()) == 256
    own = torch.zeros(3, 256, 4, 128)
    assert plan_rows(own, own) == 256
    assert plan_rows(own[:1].expand(3, -1, -1, -1), own) == 256
    seq_major = torch.zeros(256, 3, 4, 128).transpose(0, 1)
    assert plan_rows(seq_major, seq_major) == 256


def test_supported_predicate():
    """test_decode_attn.py::test_supported_predicate's cases on both
    packages (the port's scope also requires a bf16 cache)."""
    lens_t, lens_j = torch.zeros(2, dtype=torch.int32), jnp.zeros((2,), jnp.int32)
    cases = [  # (q shape, k shape, k dtype, lengths given, scales given)
        ((2, 1, 4, 128), (2, 512, 4, 128), torch.bfloat16, True, False),
        ((2, 1, 4, 128), (2, 512, 4, 128), torch.bfloat16, True, True),
        ((2, 1, 4, 128), (2, 512, 4, 128), torch.bfloat16, False, False),
        ((2, 1, 4, 128), (2, 512, 4, 128), torch.int8, True, False),
        ((2, 1, 4, 64), (2, 512, 4, 64), torch.bfloat16, True, False),
        ((2, 1, 3, 40), (2, 512, 3, 40), torch.bfloat16, True, False),
        ((2, 1, 4, 128), (2, 96, 4, 128), torch.bfloat16, True, False),
    ]
    for qs, ks, kdt, has_len, has_scales in cases:
        tq, jq = _zeros(qs, torch.bfloat16)
        tk, jk = _zeros(ks, kdt)
        scales = ("s", "s") if has_scales else None
        want = jda.supported(jq, jk, lens_j if has_len else None, scales)
        got = tda.supported(tq, tk, lens_t if has_len else None, scales)
        assert got == want, (qs, ks, kdt, has_len, has_scales)
    # fp32 caches stay on the plain decode path in the port
    tq, _ = _zeros((2, 1, 4, 128), torch.float32)
    tk, _ = _zeros((2, 512, 4, 128), torch.float32)
    assert not tda.supported(tq, tk, lens_t, None)


def test_prefix_decode_eligible():
    """test_decode_attn.py::test_dispatch_gate's cases: the port keeps the
    shape scope and the need for per-row offsets and the own token's k/v,
    adds "on CUDA", and drops gill_tpu's TPU-measured minimum bucket (so the
    128-row bucket gill_tpu refuses at MIN=512 is eligible here)."""
    lens = torch.full((2,), 7, dtype=torch.int32)
    kv1 = (torch.zeros(2, 1, 4, 128, dtype=torch.bfloat16),) * 2

    def mk(s, d):
        return (torch.zeros(2, 1, 4, d, dtype=torch.bfloat16),
                torch.zeros(2, s, 4, d, dtype=torch.bfloat16))

    def elig(q, k, off, extra, scales, on_cuda=True):
        return tattn.prefix_decode_eligible(q, k, off, extra, scales,
                                            on_cuda=on_cuda)
    q, k = mk(512, 128)
    assert elig(q, k, lens - 1, kv1, None)
    assert not elig(q, k, lens - 1, kv1, None, on_cuda=False)
    q, k = mk(128, 128)
    assert elig(q, k, lens - 1, kv1, None)
    q, k = mk(512, 64)
    assert not elig(q, k, lens - 1, kv1, None)
    q, k = mk(512, 128)
    assert not elig(q, k, None, kv1, None)
    assert not elig(q, k, lens - 1, None, None)
    assert not elig(q, k, lens - 1, kv1, ("s", "s"))


def _int8_cache(rng, b, s, h, d):
    k = rng.randint(-127, 128, (b, s, h, d)).astype(np.int8)
    v = rng.randint(-127, 128, (b, s, h, d)).astype(np.int8)
    ks = (np.abs(rng.randn(b, s, h)) * 0.01 + 1e-3).astype(np.float32)
    vs = (np.abs(rng.randn(b, s, h)) * 0.01 + 1e-3).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("own_token", [True, False])
def test_int8_kv_decode_attention_matches_gill_tpu(own_token):
    """The int8-cache decode (logits x ks, probabilities x vs, the PV
    product in bf16) with per-row offsets, with and without the own
    token's k/v."""
    rng = np.random.RandomState(4)
    b, s, h, d = 3, 64, 2, 32
    k, v, ks, vs = _int8_cache(rng, b, s, h, d)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k1 = rng.randn(b, 1, h, d).astype(np.float32)
    v1 = rng.randn(b, 1, h, d).astype(np.float32)
    off = np.array([0, 20, 63], np.int32)
    extra_j = (jnp.asarray(k1), jnp.asarray(v1)) if own_token else None
    extra_t = (torch.from_numpy(k1), torch.from_numpy(v1)) if own_token \
        else None
    want = np.asarray(jattn._decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d ** -0.5,
        kv_offset=jnp.asarray(off), extra_kv=extra_j,
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs))).astype(jnp.float32))
    got = tattn._decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=d ** -0.5, kv_offset=torch.from_numpy(off), extra_kv=extra_t,
        kv_scales=(torch.from_numpy(ks), torch.from_numpy(vs)))
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - want).max()) \
        <= 4 * BF16_ULP * float(np.abs(want).max())


def test_decode_step_through_the_dispatcher_matches_gill_tpu():
    """test_decode_attn.py::test_decode_step_logits_through_kernel's setup
    on the CPU: a (B,) cache_pos through models/opt.py's decode, mixed
    offsets incl. a parked slot, against gill_tpu's step."""
    import jax

    from gill_tpu.config import OPTConfig
    from gill_tpu.models import opt as jopt
    from gill_tpu_torch import config as tcfg
    from gill_tpu_torch.models import opt as topt
    from gill_tpu_torch.weights.from_jax import opt_from_jax

    cfg = OPTConfig(num_layers=2, hidden_size=256, ffn_dim=512, num_heads=2,
                    vocab_size=128, max_positions=256, word_embed_proj_dim=256)
    params = jax.device_get(jopt.init(jax.random.PRNGKey(5), cfg))
    b, s = 3, 64
    rng = np.random.RandomState(4)
    cache = {key: (rng.randn(2, b, s, 2, 128) * 0.1).astype(np.float32)
             for key in ("k", "v")}
    pos = np.array([13, 0, s - 1], np.int32)
    ids = np.array([[7], [9], [11]], np.int32)
    jout = jopt.forward(params, cfg, jopt.embed_tokens(params, jnp.asarray(ids)),
                        cache={k: jnp.asarray(x) for k, x in cache.items()},
                        cache_pos=jnp.asarray(pos))
    tp = opt_from_jax(params)
    tcache = {k: torch.from_numpy(x.copy()) for k, x in cache.items()}
    tout = topt.forward(tp, tcfg.OPTConfig(**cfg.__dict__),
                        topt.embed_tokens(tp, torch.from_numpy(ids).long()),
                        cache=tcache, cache_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), atol=1e-4,
                               rtol=1e-4)
    # the token's k/v landed at (layer, b, pos[b]) and nowhere else
    np.testing.assert_allclose(tcache["k"].numpy(),
                               np.asarray(jout["cache"]["k"]), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d", [(4, 64, 4, 32), (2, 48, 2, 128)])
def test_library_call_computes_the_plain_version(dtype, b, s, h, d):
    """chip_smoke's K6 library time (`decode_sdpa`: SDPA over the rows with
    the own token appended and a boolean valid-prefix mask) computes the
    kernel's function: within 2e-6 of the plain version in fp32, one bf16
    ulp of the largest output in bf16, on a parked, a full and a strided
    window of a larger pool."""
    import chip_smoke

    rng = np.random.RandomState(b * s + d)
    q, _, _, k1, v1 = (torch.from_numpy(x).to(dtype)
                       for x in _inputs(rng, b, s, h, d))
    pool = torch.from_numpy(rng.randn(2, b, s + 16, h, d).astype(
        np.float32)).to(dtype)
    k, v = pool[0, :, :s], pool[1, :, :s]
    lens = torch.from_numpy(rng.randint(0, s + 1, b).astype(np.int32))
    lens[0], lens[-1] = 0, s
    scale = d ** -0.5
    want = tda.prefix_decode_attention_ref(q, k, v, lens, k1, v1,
                                           scale=scale)
    got = chip_smoke.decode_sdpa(torch, q, k, v, lens, k1, v1, scale)()
    assert got.shape == want.shape == (b, 1, h, d) and got.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else \
        BF16_ULP * float(want.float().abs().max())
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=0)
