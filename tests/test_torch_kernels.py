"""The hand-written CUDA kernels against their plain PyTorch versions on a
GPU. Skipped (with a reason) where no CUDA device is present.

This file imports neither JAX nor gill_tpu, so on a machine with a card and
no JAX it runs on its own, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: fp32 1e-4 absolute (fp32 FMA sums in another order); bf16
attention two bf16 ulps of the largest output (both sides round one fp32
value to bf16); bf16 GEGLU four ulps (the plain version rounds the
projection and the gated product to bf16, the kernel keeps fp32 until the
gated product); the W8 matmul two bf16 ulps of the largest output for bf16
outputs and 1e-5 of it for fp32 outputs (fp32 sums in another order, one
rounding); the decode attention the same per batch row, from that row's
own largest output (a row averages its valid cache rows of v, so long rows
are far smaller than a parked row's own v1), and a parked row exactly v1.
"""

import pytest
import torch

from gill_tpu_torch.ops import attention as attn
from gill_tpu_torch.ops import decode_attn
from gill_tpu_torch.ops import geglu
from gill_tpu_torch.ops import w8_matmul as w8

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,t,s,causal", [
    (40, 200, 77, False), (64, 257, 257, False), (80, 130, 130, False),
    (128, 320, 320, True), (128, 100, 300, True), (160, 64, 77, False),
    (512, 96, 96, False)])
def test_flash_kernel_matches_plain(cuda, d, t, s, causal, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(d + t)
    q, k, v = (torch.randn(2, n, 3, d, device=cuda, generator=g).to(dt)
               for n in (t, s, s))
    before = attn.flash_attention.launches
    got = attn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    want = attn.flash_attention_ref(q, k, v, causal=causal)
    tol = 1e-4 if dt == torch.float32 else 2 * 2.0 ** -7 * float(
        want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_kernel_takes_strided_views(cuda):
    """q/k/v as head-split views of one fused projection (non-contiguous
    batch/row strides, unit last stride) need no copy."""
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn(2, 300, 3, 4, 64, device=cuda, generator=g)
    q, k, v = qkv.unbind(2)
    got = attn.flash_attention(q, k, v, causal=True)
    want = attn.flash_attention_ref(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("d,m", [(320, 8192), (320, 77), (640, 2048),
                                 (1280, 512), (1280, 130)])
def test_geglu_kernel_matches_plain(cuda, d, m):
    g = torch.Generator(cuda).manual_seed(d + m)
    bf = torch.bfloat16
    x = torch.randn(m, d, device=cuda, generator=g).to(bf)
    w1 = (torch.randn(d, 8 * d, device=cuda, generator=g) / d ** 0.5).to(bf)
    b1 = (0.1 * torch.randn(8 * d, device=cuda, generator=g)).to(bf)
    w2 = (torch.randn(4 * d, d, device=cuda, generator=g) / (2 * d ** 0.5)
          ).to(bf)
    b2 = (0.1 * torch.randn(d, device=cuda, generator=g)).to(bf)
    before = geglu.geglu_ff.launches
    got = geglu.geglu_ff(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert geglu.geglu_ff.launches == before + 1
    want = geglu.geglu_ff_ref(x, w1, b1, w2, b2).float()
    tol = 4 * 2.0 ** -7 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_masks_past_kv_len(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(1, n, 2, 64, device=cuda, generator=g).to(dt)
               for n in (70, 130, 130))
    got = attn.flash_attention(q, k, v, kv_len=77)
    want = attn.flash_attention_ref(q, k[:, :77], v[:, :77])
    tol = 1e-4 if dt == torch.float32 else 2 * 2.0 ** -7 * float(
        want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_geglu_kernel_takes_unaligned_views(cuda):
    """An input whose base is not 16-byte aligned is copied to an aligned
    buffer before the kernel's vector loads."""
    g = torch.Generator(cuda).manual_seed(2)
    m, d = 40, 320
    buf = torch.randn(m * d + 1, device=cuda, generator=g).bfloat16()
    x = buf[1:].view(m, d)
    assert x.data_ptr() % 16 != 0
    w1 = (torch.randn(d, 8 * d, device=cuda, generator=g) / d ** 0.5).bfloat16()
    b1 = torch.zeros(8 * d, device=cuda, dtype=torch.bfloat16)
    w2 = (torch.randn(4 * d, d, device=cuda, generator=g) / d).bfloat16()
    b2 = torch.zeros(d, device=cuda, dtype=torch.bfloat16)
    got = geglu.geglu_ff(x, w1, b1, w2, b2).float()
    want = geglu.geglu_ff_ref(x, w1, b1, w2, b2).float()
    assert float((got - want).abs().max()) <= 4 * 2.0 ** -7 * float(
        want.abs().max())


def _out_tol(ref):
    top = float(ref.float().abs().max())
    return (2 * 2.0 ** -7 if ref.dtype == torch.bfloat16 else 1e-5) * top


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(16, 4096, 4096), (8, 4096, 16384),
                                   (1, 16384, 4096), (100, 1024, 512),
                                   (256, 512, 1536)])
def test_w8_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, device=cuda, generator=g).to(dt)
    w = torch.randint(-127, 128, (k, n), device=cuda, generator=g,
                      dtype=torch.int8)
    ws = 1e-4 + 1e-3 * torch.rand(n, device=cuda, generator=g)
    b = torch.randn(n, device=cuda, generator=g).to(dt)
    before = w8.w8_matmul.launches
    got = w8.w8_matmul(x, w, ws, b)
    torch.cuda.synchronize()
    assert w8.w8_matmul.launches == before + 1
    assert got.dtype == dt and tuple(got.shape) == (m, n)
    want = w8.w8_matmul_ref(x, w, ws, b)
    assert float((got.float() - want.float()).abs().max()) <= _out_tol(want)
    nob = w8.w8_matmul(x, w, ws)
    assert float((nob.float() - w8.w8_matmul_ref(x, w, ws).float())
                 .abs().max()) <= _out_tol(want)


def test_w8_matmul_stacked_takes_the_layer_view(cuda):
    """K5: layer i of an (L, K, N) stack is a view; no copy is made."""
    g = torch.Generator(cuda).manual_seed(5)
    stack = torch.randint(-127, 128, (3, 1024, 512), device=cuda, generator=g,
                          dtype=torch.int8)
    x = torch.randn(2, 4, 1024, device=cuda, generator=g).bfloat16()
    ws = 1e-4 + 1e-3 * torch.rand(512, device=cuda, generator=g)
    for i in range(3):
        got = w8.w8_matmul_stacked(x, stack, ws, None, i)
        want = w8.w8_matmul_ref(x, stack[i], ws)
        assert tuple(got.shape) == (2, 4, 512)
        assert float((got.float() - want.float()).abs().max()) \
            <= _out_tol(want)


def test_w8_matmul_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(300, 512, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(512, 512, device=cuda, dtype=torch.int8)
    ws = torch.ones(512, device=cuda)
    with pytest.raises(ValueError):
        w8.w8_matmul(x, w, ws)                       # M > 256
    with pytest.raises(ValueError):
        w8.w8_matmul(x[:4, :384], w[:384], ws)       # K not a multiple of 512
    with pytest.raises(TypeError):
        w8.w8_matmul(x[:4].half(), w, ws)


def _assert_rows_close(got, want, unit):
    """Each batch row within `unit` times its own largest |want|."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    tol = unit * want.float().abs().flatten(1).amax(1)
    assert bool((err <= tol).all()), (err.tolist(), tol.tolist())


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,d", [(16, 256, 32, 128), (8, 512, 32, 128),
                                     (3, 64, 4, 256), (2, 128, 2, 512)])
def test_decode_attn_kernel_matches_plain(cuda, b, s, h, d, q_dtype):
    """Random lengths with a parked row (0) and a full one (S), on a strided
    read window of a larger pool."""
    g = torch.Generator(cuda).manual_seed(b * s + d)
    pool = torch.randn(2, b, s + 64, h, d, device=cuda, generator=g).bfloat16()
    k, v = pool[0, :, :s], pool[1, :, :s]
    assert not k.is_contiguous()
    q = torch.randn(b, 1, h, d, device=cuda, generator=g).to(
        getattr(torch, q_dtype))
    k1, v1 = (torch.randn(b, 1, h, d, device=cuda, generator=g).bfloat16()
              for _ in range(2))
    lens = torch.randint(0, s + 1, (b,), device=cuda, generator=g,
                         dtype=torch.int32)
    lens[0], lens[-1] = 0, s
    before = decode_attn.prefix_decode_attention.launches
    got = decode_attn.prefix_decode_attention(q, k, v, lens, k1, v1,
                                              scale=d ** -0.5)
    torch.cuda.synchronize()
    assert decode_attn.prefix_decode_attention.launches == before + 1
    assert got.dtype == q.dtype
    want = decode_attn.prefix_decode_attention_ref(q, k, v, lens, k1, v1,
                                                   scale=d ** -0.5)
    _assert_rows_close(got, want, 2 * 2.0 ** -7 if q_dtype == "bfloat16"
                       else 1e-5)
    # the parked row is its own value, exactly (weight exp(0) = 1, sum 1)
    assert torch.equal(got[0].float(), v1[0].float())


def test_decode_step_takes_the_kernel_through_the_dispatcher(cuda):
    """A (B,) position vector over a bf16 cache with D = 128 routes the
    decode attention to the kernel."""
    g = torch.Generator(cuda).manual_seed(9)
    q, k1, v1 = (torch.randn(4, 1, 2, 128, device=cuda, generator=g)
                 .bfloat16() for _ in range(3))
    cache = torch.randn(2, 4, 256, 2, 128, device=cuda, generator=g).bfloat16()
    off = torch.tensor([-1, 10, 100, 255], device=cuda, dtype=torch.int32)
    before = decode_attn.prefix_decode_attention.launches
    got = attn.dot_product_attention(q, cache[0], cache[1], causal=True,
                                     kv_offset=off, extra_kv=(k1, v1))
    assert decode_attn.prefix_decode_attention.launches == before + 1
    want = attn._decode_attention(q, cache[0], cache[1], scale=128 ** -0.5,
                                  kv_offset=off, extra_kv=(k1, v1))
    _assert_rows_close(got, want, 4 * 2.0 ** -7)
