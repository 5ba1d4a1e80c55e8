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
rounding), at every row tile, launch plan and serving shape, one launch a
call and the same bits twice; the decode attention the same per batch row, from that row's
own largest output (a row averages its valid cache rows of v, so long rows
are far smaller than a parked row's own v1), a parked row exactly v1, rows
ending on split boundaries, and the same bits twice.
The LN-folded kernels (LN-matmul, stacked LN-matmul, LN-folded GEGLU) four
bf16 ulps of the largest output, as GEGLU (the plain version rounds its
LayerNorm and product sums to bf16 at other points, and its row statistics
sum in another order); the int8-QK attention two bf16 ulps (both quantize
identically, so the int8 values and int32 scores are equal and only the
softmax's summation order differs), and its pre-pass exactly equal to the
plain version on the CPU. The UNet's bf16 attention at head dims <= 80
(csrc/flash_mma.cu) two bf16 ulps at every tile it takes; K1 (fp32 on
csrc/flash_attn.cu, bf16 at head dims 128-512 on csrc/flash_mma.cu) the
same 1e-4 / two bf16 ulps at each of its main-path shapes, ragged and
causal calls, `kv_len` and fused views. The probe kernels: the repeated-product
probe (S1) int8 exactly equal and bf16 within 1e-5 of the largest output,
relative (fp32 sums in another order); the sweep's flash variants (S2, S3)
two bf16 ulps of the largest output, as flash attention, two calls bit
for bit, and the bf16-probability single-pass mode at wide scores within
a quarter of the gap between the plain versions with bf16 and fp32
probabilities.
"""

import pytest
import torch

from gill_tpu_torch.ops import attention as attn
from gill_tpu_torch.ops import decode_attn
from gill_tpu_torch.ops import flash_variants as fv
from gill_tpu_torch.ops import geglu
from gill_tpu_torch.ops import ln_matmul as lnm
from gill_tpu_torch.ops import mm_probe as mp
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
    """K1 (csrc/flash_attn.cu) and, for bf16 at d <= 80, K2
    (csrc/flash_mma.cu), each counted on its own attribute."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(d + t)
    q, k, v = (torch.randn(2, n, 3, d, device=cuda, generator=g).to(dt)
               for n in (t, s, s))
    counter = ("mma_launches" if attn.mma_eligible(dt, d) else "launches")
    before = getattr(attn.flash_attention, counter)
    got = attn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert getattr(attn.flash_attention, counter) == before + 1
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


def _flash_close(got, want):
    """Two bf16 ulps of the largest output (a NaN fails)."""
    err = float((got.float() - want.float()).abs().max())
    return err <= 2 * 2.0 ** -7 * float(want.float().abs().max())


# K2's four UNet shapes at full size (CFG batch 2, 8 heads), then ragged
# query counts, 77 keys, causal calls and a head dim the wrapper pads
MMA_CASES = [(2, 4096, 4096, 8, 40, False), (2, 4096, 77, 8, 40, False),
             (2, 1024, 1024, 8, 80, False), (2, 1024, 77, 8, 80, False),
             (2, 200, 77, 3, 40, False), (2, 130, 130, 3, 80, False),
             (1, 320, 320, 4, 80, True), (1, 100, 300, 4, 40, True),
             (1, 70, 130, 2, 36, False)]


@pytest.mark.parametrize("b,t,s,h,d,causal", MMA_CASES)
def test_flash_mma_kernel_matches_plain(cuda, b, t, s, h, d, causal):
    g = torch.Generator(cuda).manual_seed(t + s + d)
    q, k, v = (torch.randn(b, n, h, d, device=cuda, generator=g).bfloat16()
               for n in (t, s, s))
    before = (attn.flash_attention.mma_launches, attn.flash_attention.launches)
    got = attn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (attn.flash_attention.mma_launches,
            attn.flash_attention.launches) == (before[0] + 1, before[1])
    assert got.is_contiguous() and got.shape == q.shape
    assert _flash_close(got, attn.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("block_k", [0, 64, 128])
@pytest.mark.parametrize("block_q", [0, 64, 128])
@pytest.mark.parametrize("t,s,d", [(4096, 4096, 40), (1024, 77, 80),
                                   (200, 130, 40)])
def test_flash_mma_kernel_takes_every_tile(cuda, t, s, d, block_q, block_k):
    g = torch.Generator(cuda).manual_seed(t + d)
    b, h = (2, 8) if t >= 1024 else (1, 3)
    q, k, v = (torch.randn(b, n, h, d, device=cuda, generator=g).bfloat16()
               for n in (t, s, s))
    got = attn.flash_attention(q, k, v, block_q=block_q, block_k=block_k)
    assert _flash_close(got, attn.flash_attention_ref(q, k, v))


def test_flash_mma_kernel_takes_fused_and_unaligned_views(cuda):
    """Head-split views of one fused (B, T, 3, H, D) projection go in as
    they are; a view whose base is not 16-byte aligned is copied first."""
    g = torch.Generator(cuda).manual_seed(3)
    qkv = torch.randn(2, 300, 3, 4, 40, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.unbind(2)
    want = attn.flash_attention_ref(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    assert _flash_close(attn.flash_attention(q, k, v), want)
    buf = torch.randn(70 * 2 * 40 + 1, device=cuda, generator=g).bfloat16()
    x = buf[1:].view(1, 70, 2, 40)
    assert x.data_ptr() % 16 != 0
    assert _flash_close(attn.flash_attention(x, x, x),
                        attn.flash_attention_ref(x, x, x))


def test_flash_mma_kernel_refuses_unsupported_tiles(cuda):
    """An unsupported block_q / block_k, or a tile asked of a call that
    takes csrc/flash_attn.cu, raises before any launch."""
    q = torch.zeros(1, 64, 2, 40, device=cuda, dtype=torch.bfloat16)
    before = (attn.flash_attention.mma_launches, attn.flash_attention.launches)
    for bq, bk in ((32, 0), (0, 256), (96, 64), (-64, 64)):
        with pytest.raises(ValueError):
            attn.flash_attention(q, q, q, block_q=bq, block_k=bk)
    with pytest.raises(ValueError):
        attn.flash_attention(q.float(), q.float(), q.float(), block_q=64)
    big = torch.zeros(1, 64, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn.flash_attention(big, big, big, block_k=64)
    assert (attn.flash_attention.mma_launches,
            attn.flash_attention.launches) == before


def test_unet_call_launches_the_mma_kernel(cuda):
    """A bf16 UNet at SD v1.5's widths (320 and 640 channels, 8 heads:
    head dims 40 and 80), two levels: its 14 attention calls take K2, and
    under q8=True K10, both on csrc/flash_mma.cu; none takes K1."""
    from gill_tpu_torch import config as tcfg
    from gill_tpu_torch.models.sd import unet
    from gill_tpu_torch.nn.core import Init, tree_map

    cfg = tcfg.UNetConfig(block_out_channels=(320, 640), layers_per_block=1,
                          down_block_types=("CrossAttnDownBlock2D",) * 2,
                          up_block_types=("CrossAttnUpBlock2D",) * 2)
    g = torch.Generator(cuda).manual_seed(0)
    params = tree_map(lambda x: x.bfloat16(), unet.init(Init(g, cuda), cfg))
    lat = torch.randn(2, 16, 16, 4, device=cuda, generator=g).bfloat16()
    ctx = torch.randn(2, 77, 768, device=cuda, generator=g).bfloat16()
    t = torch.tensor(501.0, device=cuda)
    fa, fq = attn.flash_attention, attn.flash_attention_q8
    for q8 in (False, True):
        before = (fa.mma_launches, fq.launches, fa.launches)
        out = unet.apply(params, cfg, lat, t, ctx, q8=q8)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out.float()).all())
        assert (fa.mma_launches - before[0], fq.launches - before[1],
                fa.launches - before[2]) == (14, 14 if q8 else 0, 0)


@pytest.mark.parametrize("d,m", [(320, 8192), (320, 77), (640, 2048),
                                 (1280, 512), (1280, 130), (1280, 128)])
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
                                   (256, 512, 1536), (8, 1536, 2560),
                                   (1, 1536, 2560)])
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


def _w8_operands(g, dev, m, k, n, dt, layers=None):
    x = torch.randn(m, k, device=dev, generator=g).to(dt)
    w = torch.randint(-127, 128, ((layers,) if layers else ()) + (k, n),
                      device=dev, generator=g, dtype=torch.int8)
    ws = 1e-4 + 1e-3 * torch.rand(n, device=dev, generator=g)
    b = (0.1 * torch.randn(n, device=dev, generator=g)).to(dt)
    return x, w, ws, b


def _w8_close(got, x, w, ws, b):
    want = w8.w8_matmul_ref(x, w, ws, b)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= _out_tol(want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 64, 255, 256])
def test_w8_matmul_kernel_takes_every_row_count(cuda, m, dtype):
    """Every row tile of `w8_plan` and its ragged edges, at the decode
    shape 4096 x 4096."""
    dt = getattr(torch, dtype)
    x, w, ws, b = _w8_operands(torch.Generator(cuda).manual_seed(m), cuda,
                               m, 4096, 4096, dt)
    _w8_close(w8.w8_matmul(x, w, ws, b), x, w, ws, b)


@pytest.mark.parametrize("dtype,m", [("bfloat16", 8), ("bfloat16", 16),
                                     ("bfloat16", 100), ("float32", 1)])
@pytest.mark.parametrize("block_k", [64, 128, 256])
@pytest.mark.parametrize("block_n", [64, 128])
def test_w8_matmul_kernel_takes_every_plan(cuda, block_n, block_k, dtype, m):
    """Every (block_n, block_k) that `w8_plan` accepts at 4096 x 4096
    launches once and is right; the rest raise ValueError on the card as
    on the CPU."""
    dt = getattr(torch, dtype)
    x, w, ws, b = _w8_operands(torch.Generator(cuda).manual_seed(block_k),
                               cuda, m, 4096, 4096, dt)
    try:
        w8.w8_plan(m, 4096, 4096, dt, block_n=block_n, block_k=block_k)
    except ValueError:
        with pytest.raises(ValueError):
            w8.w8_matmul(x, w, ws, b, block_n=block_n, block_k=block_k)
        return
    before = w8.w8_matmul.launches
    got = w8.w8_matmul(x, w, ws, b, block_n=block_n, block_k=block_k)
    torch.cuda.synchronize()
    assert w8.w8_matmul.launches == before + 1
    _w8_close(got, x, w, ws, b)


@pytest.mark.parametrize("m,k,n,dtype,splits", [
    (1, 1536, 2560, "bfloat16", 3), (1, 2560, 512, "bfloat16", 5),
    (1, 1536, 512, "bfloat16", 6), (1, 3584, 512, "bfloat16", 7),
    (1, 1536, 3072, "float32", 3), (1, 2560, 512, "float32", 5),
    (1, 1536, 512, "float32", 6), (1, 3584, 512, "float32", 7),
    (1, 4096, 4096, "bfloat16", 2), (1, 4096, 512, "float32", 8)])
def test_w8_matmul_kernel_takes_every_cluster_size(cuda, m, k, n, dtype,
                                                   splits):
    """K split over clusters of 2-8 blocks (so on the H100's 132 SMs),
    also where the split does not divide the strip's columns (3, 5, 6,
    7): every output column is summed and stored."""
    dt = getattr(torch, dtype)
    assert w8.w8_plan(m, k, n, dt, w8.H100_SMS).splits == splits
    x, w, ws, b = _w8_operands(torch.Generator(cuda).manual_seed(k + n),
                               cuda, m, k, n, dt)
    _w8_close(w8.w8_matmul(x, w, ws, b), x, w, ws, b)


def test_w8_matmul_stacked_takes_a_later_layer_at_decode_width(cuda):
    """K5 at OPT-6.7B's width: layer 2 of a (3, 4096, 4096) stack, a view
    whose start is 32 MiB into the stack."""
    x, st, ws, b = _w8_operands(torch.Generator(cuda).manual_seed(6), cuda,
                                16, 4096, 4096, torch.bfloat16, layers=3)
    _w8_close(w8.w8_matmul_stacked(x, st, ws, b, 2), x, st[2], ws, b)


W8_SERVING = [(16, 4096, 4096, "bfloat16"), (16, 4096, 16384, "bfloat16"),
              (16, 16384, 4096, "bfloat16"), (8, 4096, 4096, "bfloat16"),
              (256, 4096, 16384, "bfloat16"), (1, 16384, 4096, "float32")]


@pytest.mark.parametrize("m,k,n,dtype", W8_SERVING)
def test_w8_matmul_kernel_is_one_deterministic_launch(cuda, m, k, n, dtype):
    """One kernel on the device a call (no reduction kernel, no memset),
    and two calls on the same inputs agree bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, w, ws, b = _w8_operands(torch.Generator(cuda).manual_seed(k + n),
                               cuda, m, k, n, getattr(torch, dtype))
    first = w8.w8_matmul(x, w, ws, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = w8.w8_matmul(x, w, ws, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "w8_" in kernels[0], kernels
    assert torch.equal(first, again)
    _w8_close(first, x, w, ws, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_w8_plan_is_the_c_sides(cuda, dtype):
    """`w8_plan` and csrc/w8_matmul.cu's `plan_for` give the same geometry,
    and refuse the same calls, over row counts, shapes and block sizes."""
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in (1, 7, 8, 9, 16, 17, 64, 255, 256):
        for k, n in ((512, 512), (4096, 4096), (4096, 16384), (16384, 4096),
                     (1536, 2560), (512, 1536)):
            for bn in (None, 32, 64, 128):
                for bk in (None, 64, 128, 256, 512):
                    try:
                        p = w8.w8_plan(m, k, n, dt, sms, bn, bk)
                        want = (p.block_n, p.block_k, p.stages, p.splits,
                                p.row_tile, p.blocks)
                    except ValueError:
                        want = None
                    assert w8.c_plan(m, k, n, dt, sms, bn, bk) == want, \
                        (m, k, n, bn, bk)


def _assert_rows_close(got, want, unit):
    """Each batch row within `unit` times its own largest |want|."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    tol = unit * want.float().abs().flatten(1).amax(1)
    assert bool((err <= tol).all()), (err.tolist(), tol.tolist())


DECODE_CASES = [(16, 256, 32, 128), (8, 512, 32, 128), (4, 2048, 32, 128),
                (3, 64, 4, 256), (2, 128, 2, 512), (5, 100, 3, 128)]


def _decode_case(dev, b, s, h, d, q_dtype):
    """Random lengths with a parked row (0), a full one (S) and, where the
    batch has room, rows ending on the plan's split boundaries (the first
    split's end, the last split's start), on a strided read window of a
    larger pool."""
    g = torch.Generator(dev).manual_seed(b * s + d)
    pool = torch.randn(2, b, s + 64, h, d, device=dev, generator=g).bfloat16()
    k, v = pool[0, :, :s], pool[1, :, :s]
    assert not k.is_contiguous()
    q = torch.randn(b, 1, h, d, device=dev, generator=g).to(
        getattr(torch, q_dtype))
    k1, v1 = (torch.randn(b, 1, h, d, device=dev, generator=g).bfloat16()
              for _ in range(2))
    lens = torch.randint(0, s + 1, (b,), device=dev, generator=g,
                         dtype=torch.int32)
    plan = decode_attn.decode_plan(
        b, s, h, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    edges = [plan.rows, (plan.splits - 1) * plan.rows]
    for i, e in enumerate(edges[:max(0, b - 2)]):
        lens[1 + i] = e
    lens[0], lens[-1] = 0, s
    return q, k, v, lens, k1, v1


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,d", DECODE_CASES)
def test_decode_attn_kernel_matches_plain(cuda, b, s, h, d, q_dtype):
    q, k, v, lens, k1, v1 = _decode_case(cuda, b, s, h, d, q_dtype)
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


@pytest.mark.parametrize("b,s,h,d", DECODE_CASES)
def test_decode_attn_kernel_gives_the_same_bits_twice(cuda, b, s, h, d):
    """The splits merge in rank order: two calls agree bit for bit."""
    args = _decode_case(cuda, b, s, h, d, "bfloat16")
    a = decode_attn.prefix_decode_attention(*args, scale=d ** -0.5)
    again = decode_attn.prefix_decode_attention(*args, scale=d ** -0.5)
    assert torch.equal(a, again)


@pytest.mark.parametrize("b,s,h,d", DECODE_CASES + [(64, 128, 32, 128),
                                                    (1, 8, 1, 512)])
@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_decode_plan_is_the_c_sides(cuda, b, s, h, d, num_sms):
    assert decode_attn.c_plan(b, s, h, d, num_sms) == tuple(
        decode_attn.decode_plan(b, s, h, d, num_sms))
    assert decode_attn.c_plan(b, s, h, 64, num_sms) is None


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


def _ulps(got, want, n):
    want = want.float()
    return float((got.float() - want).abs().max()) <= n * 2.0 ** -7 * float(
        want.abs().max())


def _ln_case(g, dev, m, d, k):
    bf = torch.bfloat16
    x = (2 * torch.randn(m, d, device=dev, generator=g) + 0.3).to(bf)
    gamma = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    beta = (0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    w = (torch.randn(k, d, d, device=dev, generator=g) / d ** 0.5).to(bf)
    return x, gamma, beta, w


@pytest.mark.parametrize("m,d", [(8192, 320), (2048, 640), (77, 320),
                                 (130, 640)])
def test_ln_matmul_kernels_match_plain(cuda, m, d):
    """K7 (the cross-attention q) and K8 (self-attention q/k/v) at the
    UNet's shapes and ragged row counts."""
    g = torch.Generator(cuda).manual_seed(m + d)
    x, gamma, beta, w = _ln_case(g, cuda, m, d, 3)
    before = (lnm.ln_matmul.launches, lnm.ln_matmul_stacked.launches)
    got = lnm.ln_matmul(x, gamma, beta, w[0])
    got3 = lnm.ln_matmul_stacked(x.view(2, m // 2, d) if m % 2 == 0 else x,
                                 gamma, beta, w)
    torch.cuda.synchronize()
    assert (lnm.ln_matmul.launches, lnm.ln_matmul_stacked.launches) == (
        before[0] + 1, before[1] + 1)
    assert _ulps(got, lnm.ln_matmul_ref(x, gamma, beta, w[0]), 4)
    want3 = lnm.ln_matmul_stacked_ref(x, gamma, beta, w)
    assert tuple(got3.reshape(3, m, d).shape) == tuple(want3.shape)
    assert _ulps(got3.reshape(3, m, d), want3, 4)
    assert got3.is_contiguous()


def test_ln_matmul_kernel_takes_strided_views(cuda):
    """A column slice of a wider activation (non-contiguous rows) is copied
    to an aligned buffer before the kernel's vector loads."""
    g = torch.Generator(cuda).manual_seed(7)
    x, gamma, beta, w = _ln_case(g, cuda, 300, 320, 1)
    wide = torch.cat([x, x[:, :8]], dim=1)[:, :320]
    assert not wide.is_contiguous()
    assert _ulps(lnm.ln_matmul(wide, gamma, beta, w[0]),
                 lnm.ln_matmul_ref(x, gamma, beta, w[0]), 4)


def test_ln_matmul_kernels_refuse_what_they_do_not_take(cuda):
    g = torch.Generator(cuda).manual_seed(8)
    x, gamma, beta, w = _ln_case(g, cuda, 64, 320, 3)
    with pytest.raises(ValueError):
        lnm.ln_matmul(x[:, :256], gamma[:256], beta[:256], w[0, :256, :256])
    with pytest.raises(ValueError):
        lnm.ln_matmul(x, gamma, beta, w[0, :, :100])       # n % 64
    with pytest.raises(ValueError):
        lnm.ln_matmul_stacked(x, gamma, beta, torch.cat([w, w[:1]]))
    with pytest.raises(TypeError):
        lnm.ln_matmul(x.float(), gamma.float(), beta.float(), w[0].float())


@pytest.mark.parametrize("m,d", [(8192, 320), (2048, 640), (512, 1280),
                                 (128, 1280), (77, 320), (1, 320),
                                 (130, 640), (130, 1280)])
def test_geglu_ln_kernel_matches_plain(cuda, m, d):
    """K9: K3 with the LayerNorm folded in; K3's own count is untouched."""
    g = torch.Generator(cuda).manual_seed(m * d)
    x, gamma, beta, (w1, b1, w2, b2) = _geglu_case(g, cuda, m, d)
    before = (geglu.geglu_ff.launches, geglu.geglu_ff.ln_launches)
    got = geglu.geglu_ff(x, w1, b1, w2, b2, ln_gamma=gamma, ln_beta=beta)
    torch.cuda.synchronize()
    assert (geglu.geglu_ff.launches, geglu.geglu_ff.ln_launches) == (
        before[0], before[1] + 1)
    want = geglu.geglu_ff_ref(x, w1, b1, w2, b2, ln_gamma=gamma, ln_beta=beta)
    assert _ulps(got, want, 4)
    # a strided view of the same rows gives the same result, bit for bit
    wide = torch.cat([x, x[:, :8]], dim=1)[:, :d]
    assert m == 1 or not wide.is_contiguous()
    again = geglu.geglu_ff(wide, w1, b1, w2, b2, ln_gamma=gamma, ln_beta=beta)
    assert torch.equal(again, got)
    with pytest.raises(ValueError):
        geglu.geglu_ff(x, w1, b1, w2, b2, ln_gamma=gamma[:8], ln_beta=beta)
    with pytest.raises(TypeError):
        geglu.geglu_ff(x, w1, b1, w2, b2, ln_gamma=gamma.float(),
                       ln_beta=beta)


def _geglu_case(g, dev, m, d, shift=0.0):
    bf = torch.bfloat16
    x = (2 * torch.randn(m, d, device=dev, generator=g) - 0.2 + shift).to(bf)
    gamma = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    beta = (0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    w1 = (torch.randn(d, 8 * d, device=dev, generator=g) / d ** 0.5).to(bf)
    b1 = (0.1 * torch.randn(8 * d, device=dev, generator=g)).to(bf)
    w2 = (torch.randn(4 * d, d, device=dev, generator=g) / (2 * d ** 0.5)
          ).to(bf)
    b2 = (0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    return x, gamma, beta, (w1, b1, w2, b2)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("m,d", [(1, 320), (77, 320), (130, 640),
                                 (2048, 640), (8192, 320)])
def test_ln_matmul_stacked_kernel_takes_every_stack(cuda, m, d, k):
    """K8 at K = 1, 2 and 3, ragged and short row counts among them: within
    four ulps of the plain version, one count a call, two calls bit for
    bit."""
    g = torch.Generator(cuda).manual_seed(17 * m + d + k)
    x, gamma, beta, w = _ln_case(g, cuda, m, d, k)
    before = lnm.ln_matmul_stacked.launches
    got = lnm.ln_matmul_stacked(x, gamma, beta, w)
    again = lnm.ln_matmul_stacked(x, gamma, beta, w)
    torch.cuda.synchronize()
    assert lnm.ln_matmul_stacked.launches == before + 2
    assert tuple(got.shape) == (k, m, d) and torch.equal(got, again)
    assert _ulps(got, lnm.ln_matmul_stacked_ref(x, gamma, beta, w), 4)


@pytest.mark.parametrize("m,d", [(8192, 320), (2048, 640), (77, 320)])
def test_ln_folded_kernels_at_a_large_mean(cuda, m, d):
    """Rows offset by 30, where the single-pass variance E[x^2] - mean^2
    loses the most: K7, K8 and K9 within four ulps of their plain
    versions (which compute the same single-pass statistics)."""
    g = torch.Generator(cuda).manual_seed(m + 3 * d)
    x, gamma, beta, w = _ln_case(g, cuda, m, d, 3)
    x = (x.float() + 30).bfloat16()
    assert _ulps(lnm.ln_matmul(x, gamma, beta, w[0]),
                 lnm.ln_matmul_ref(x, gamma, beta, w[0]), 4)
    assert _ulps(lnm.ln_matmul_stacked(x, gamma, beta, w),
                 lnm.ln_matmul_stacked_ref(x, gamma, beta, w), 4)
    x, gamma, beta, ff = _geglu_case(g, cuda, m, d, shift=30.0)
    ln = dict(ln_gamma=gamma, ln_beta=beta)
    assert _ulps(geglu.geglu_ff(x, *ff, **ln),
                 geglu.geglu_ff_ref(x, *ff, **ln), 4)


def test_ln_matmul_rows_do_not_depend_on_the_plan(cuda):
    """A row's product is the same bit for bit whether its block takes 128
    rows and two weight boxes (8192 rows) or 64 rows and one box (130
    rows), and whatever the rows around it: the statistics and each box's
    sums depend on the row and its box alone."""
    g = torch.Generator(cuda).manual_seed(31)
    x, gamma, beta, w = _ln_case(g, cuda, 8192, 320, 3)
    assert lnm.ln_matmul_plan(8192, 320, 320, 3)[:2] == (128, 2)
    assert lnm.ln_matmul_plan(130, 320, 320, 3)[:2] == (64, 1)
    full = lnm.ln_matmul_stacked(x, gamma, beta, w)
    part = lnm.ln_matmul_stacked(x[3968:4098], gamma, beta, w)
    assert torch.equal(full[:, 3968:4098], part)
    assert torch.equal(lnm.ln_matmul(x[:130], gamma, beta, w[1]),
                       full[1, :130])


def test_ln_matmul_plan_is_the_c_sides(cuda):
    """`ln_matmul_plan` and csrc/ln_matmul.cu's `plan_for` give the same
    launch, and refuse the same calls."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in (0, 1, 77, 128, 130, 2048, 8192, 20000):
        for d in (256, 320, 640, 1280):
            for n in (0, 64, 100, 320, 640):
                for k in (0, 1, 2, 3, 4):
                    try:
                        want = lnm.ln_matmul_plan(m, d, n, k, sms)
                    except ValueError:
                        want = None
                    assert lnm.c_plan(m, d, n, k, sms) == want, (m, d, n, k)


@pytest.mark.parametrize("m,field,value", [(8192, "nx", 1), (8192, "bm", 64),
                                           (130, "nx", 2), (130, "bm", 128)])
def test_ln_matmul_kernel_refuses_another_plan(cuda, monkeypatch, m, field,
                                               value):
    """The entry point launches only `ln_matmul_plan`'s tile (rows and
    boxes a block): another is refused at launch, and nothing is
    counted."""
    g = torch.Generator(cuda).manual_seed(9)
    x, gamma, beta, w = _ln_case(g, cuda, m, 320, 3)
    plan = lnm.ln_matmul_plan(m, 320, 320, 3)
    assert getattr(plan, field) != value
    monkeypatch.setattr(lnm, "ln_matmul_plan",
                        lambda *a: plan._replace(**{field: value}))
    before = lnm.ln_matmul_stacked.launches
    with pytest.raises(RuntimeError):
        lnm.ln_matmul_stacked(x, gamma, beta, w)
    assert lnm.ln_matmul_stacked.launches == before


@pytest.mark.parametrize("m,d", [(8192, 320), (2048, 640), (512, 1280),
                                 (128, 1280), (77, 320)])
def test_geglu_ln_kernel_is_k3_on_the_normalized_rows(cuda, m, d):
    """K9 against K3 fed the plain LayerNorm of the same rows: the two
    share every GEMM instruction, and differ only where the statistics'
    summation order moves a bf16 scale by an ulp, so four ulps of the
    largest output hold; two K9 calls agree bit for bit, and K3 twice
    too."""
    g = torch.Generator(cuda).manual_seed(5 * m + d)
    x, gamma, beta, ff = _geglu_case(g, cuda, m, d)
    got = geglu.geglu_ff(x, *ff, ln_gamma=gamma, ln_beta=beta)
    again = geglu.geglu_ff(x, *ff, ln_gamma=gamma, ln_beta=beta)
    xn = lnm.ln_rows(x, gamma, beta)
    k3 = geglu.geglu_ff(xn, *ff)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(k3, geglu.geglu_ff(xn, *ff))
    assert _ulps(got, k3, 4)


@pytest.mark.parametrize("t,s,d,q_block", [
    (4096, 4096, 40, 1024), (4096, 77, 40, 1024), (1024, 1024, 80, 1024),
    (1024, 77, 80, 1024), (200, 130, 64, 64), (96, 77, 40, 50),
    (130, 100, 128, 64), (96, 77, 96, 50)])
def test_flash_q8_kernel_matches_plain(cuda, t, s, d, q_block):
    """K10 at the UNet's q8 shapes (B 2, H 8), a ragged case with partial
    query groups not aligned to the kernel's query tiles, and q as a view
    of a fused q/k/v projection. Counted on its own wrapper and, as a
    launch of csrc/flash_mma.cu, on flash_attention.mma_launches."""
    g = torch.Generator(cuda).manual_seed(t + s + d)
    bf = torch.bfloat16
    b, h = (2, 8) if t >= 1024 else (1, 3)
    qkv = torch.randn(b, t, 3, h, d, device=cuda, generator=g).to(bf)
    q = qkv[:, :, 0]
    k = (1.5 * torch.randn(b, s, h, d, device=cuda, generator=g)).to(bf)
    v = torch.randn(b, s, h, d, device=cuda, generator=g).to(bf)
    before = (attn.flash_attention_q8.launches,
              attn.flash_attention.mma_launches)
    got = attn.flash_attention_q8(q, k, v, scale=d ** -0.5, q_block=q_block)
    torch.cuda.synchronize()
    assert (attn.flash_attention_q8.launches,
            attn.flash_attention.mma_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert got.is_contiguous() and got.dtype == bf
    want = attn.flash_attention_q8_ref(q, k, v, scale=d ** -0.5,
                                       q_block=q_block)
    assert _ulps(got, want, 2)


@pytest.mark.parametrize("b,t,s,h,d,q_block", [
    (2, 4096, 4096, 8, 40, 1024), (2, 4096, 77, 8, 40, 1024),
    (2, 1024, 1024, 8, 80, 1024), (2, 1024, 77, 8, 80, 1024),
    (1, 96, 77, 3, 40, 50), (1, 70, 33, 2, 36, 64),
    (1, 130, 100, 2, 128, 64)])
def test_flash_q8_prepass_is_bit_equal_to_plain(cuda, b, t, s, h, d, q_block):
    """K10's pre-pass against `quantize_qk_ref` on the CPU, exactly: the
    int8 values, their zero padding and the scales. (On CUDA, PyTorch
    divides by a Python scalar as a product with its reciprocal, so the
    plain version's scales are compared where it divides truly.) Then the
    main kernel on the pre-pass's result, as `qk8`, against the plain
    attention. d 36 takes the pre-pass's element-wise loads."""
    g = torch.Generator(cuda).manual_seed(t + s + d)
    qkv = torch.randn(b, t, 3, h, d, device=cuda, generator=g).bfloat16()
    q = qkv[:, :, 0]
    k = (1.5 * torch.randn(b, s, h, d, device=cuda, generator=g)).bfloat16()
    v = torch.randn(b, s, h, d, device=cuda, generator=g).bfloat16()
    got = attn.quantize_qk(q, k, q_block=q_block)
    want = attn.quantize_qk_ref(q.cpu(), k.cpu(), q_block=q_block)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y)
    out = attn.flash_attention_q8(q, k, v, scale=d ** -0.5, q_block=q_block,
                                  qk8=got)
    assert _flash_close(out, attn.flash_attention_q8_ref(
        q, k, v, scale=d ** -0.5, q_block=q_block))


def test_flash_q8_prepass_division_is_exact_for_every_bf16(cuda):
    """The pre-pass divides by the scale with one reciprocal and two FMAs;
    its int8 equals a true division's for every bf16 x with |x| <= amax
    and every positive finite bf16 amax (the scale max(amax / 127,
    1e-12)): 32,639 x up to 65,536 pairs, all of them."""
    from gill_tpu_torch.ops._build import check

    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    check(attn._mma_lib().gill_flash_mma_q8_check_division(
        bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "quant8_check")
    assert int(bad) == 0


def test_flash_q8_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 2, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        attn.flash_attention_q8(q.float(), q.float(), q.float(), scale=1.0)
    big = torch.zeros(1, 64, 2, 160, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn.flash_attention_q8(big, big, big, scale=1.0)
    with pytest.raises(ValueError):
        attn.flash_attention_q8(q, q[:, :, :1], q, scale=1.0)


@pytest.mark.parametrize("m,k,n", [(8192, 36, 320), (8192, 2880, 4),
                                   (8192, 320, 2560), (10, 64, 64),
                                   (17, 20, 13)])
def test_int_mm_pads_to_what_cublas_takes(cuda, m, k, n):
    """The W8A8 products (torch._int_mm, outside any kernel of the port, as
    gill_tpu leaves them to XLA): exact int32 sums at conv_in's K = 36,
    conv_out's N = 4, a GEGLU projection and row counts under 24."""
    from gill_tpu_torch.ops import quant

    g = torch.Generator(cuda).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), device=cuda, generator=g,
                      dtype=torch.int8)
    want = a.cpu().long() @ b.cpu().long()
    for bb in (b, b.t().contiguous().t()):
        got = quant.int_mm(a, bb)
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        assert torch.equal(got.cpu().long(), want)


@pytest.mark.parametrize("m,k,n,dtype", [
    (512, 128, 2048, "bfloat16"), (512, 128, 2048, "int8"),
    (512, 4096, 128, "bfloat16"), (512, 4096, 128, "int8"),
    (40, 4096, 512, "bfloat16"), (48, 4096, 512, "bfloat16"),
    (128, 4096, 512, "bfloat16"), (37, 100, 70, "bfloat16"),
    (37, 100, 70, "int8"), (130, 1000, 300, "bfloat16"),
    (130, 1000, 300, "int8")])
def test_mm_probe_kernel_matches_plain(cuda, m, k, n, dtype):
    """S1 at the seven probe cases (normal * 3 operands, as the probe makes
    them) and ragged cases: M, K and N off every tile edge, several
    chunks."""
    g = torch.Generator(cuda).manual_seed(m + k + n)
    dt = getattr(torch, dtype)
    a = (3 * torch.randn(m, k, device=cuda, generator=g)).to(dt)
    b = (3 * torch.randn(k, n, device=cuda, generator=g)).to(dt)
    before = mp.mm_probe.launches
    got = mp.mm_probe(a, b)
    torch.cuda.synchronize()
    assert mp.mm_probe.launches == before + 1
    want = mp.mm_probe_ref(a, b)
    if dt == torch.int8:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


def test_mm_probe_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        mp.mm_probe(a.float(), a.float().t())
    with pytest.raises(ValueError):
        mp.mm_probe(a, a)


@pytest.mark.parametrize("b,t,s,h,d", [
    (8, 4096, 4096, 8, 40), (1, 192, 320, 2, 40), (2, 128, 256, 3, 48),
    (1, 64, 64, 1, 16)])
@pytest.mark.parametrize("block_q,online,probs,kt", [
    (256, False, "float32", False), (512, False, "float32", False),
    (1024, False, "float32", False), (512, True, "float32", False),
    (256, False, "bfloat16", False), (512, True, "bfloat16", False),
    (512, False, "float32", True), (512, True, "float32", True)])
def test_flash_variant_kernel_matches_plain(cuda, b, t, s, h, d, block_q,
                                            online, probs, kt):
    """S2 at the sweep's shape and at small ones (T off the 128-row tile,
    D 48 and 16, B = 1 so k's transpose must be copied): each Hopper tile,
    single-pass and online, fp32 and bf16 probabilities, k transposed."""
    g = torch.Generator(cuda).manual_seed(b + t + s + d)
    q, k, v = (torch.randn(b, n, h, d, device=cuda, generator=g)
               .to(torch.bfloat16) for n in (t, s, s))
    bq = block_q if t % block_q == 0 else 64
    bk = min(1024, s // 2) if online else s
    before = fv.flash_variant.launches
    got = fv.flash_variant(q, k, v, block_q=bq, block_k=bk,
                           prob_dtype=getattr(torch, probs), kt=kt)
    torch.cuda.synchronize()
    assert fv.flash_variant.launches == before + 1
    want = fv.flash_variant_ref(q, k, v, block_k=bk,
                                bf16_probs=probs == "bfloat16")
    assert _ulps(got, want, 2)


@pytest.mark.parametrize("b,t,s,h,d,block_q", [
    (8, 4096, 4096, 8, 40, 512), (8, 4096, 4096, 8, 40, 1024),
    (1, 192, 320, 2, 40, 64), (2, 128, 256, 3, 48, 128)])
def test_flash_nomax_kernel_matches_plain(cuda, b, t, s, h, d, block_q):
    g = torch.Generator(cuda).manual_seed(b + t + s + d)
    q, k, v = (torch.randn(b, n, h, d, device=cuda, generator=g)
               .to(torch.bfloat16) for n in (t, s, s))
    before = fv.flash_nomax.launches
    got = fv.flash_nomax(q, k, v, block_q=block_q, block_k=s)
    torch.cuda.synchronize()
    assert fv.flash_nomax.launches == before + 1
    assert _ulps(got, fv.flash_nomax_ref(q, k, v), 2)


def test_flash_nomax_kernel_keeps_the_overflow(cuda):
    """No clamp: a query row scaled by 100 overflows exp(s - 12) in the
    kernel as in its plain version; the other rows agree."""
    g = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(1, 128, 2, 40, device=cuda, generator=g)
               for _ in range(3))
    q[:, 0] *= 100
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = fv.flash_nomax(q, k, v, block_q=64, block_k=128)
    want = fv.flash_nomax_ref(q, k, v)
    assert not torch.isfinite(got[:, 0]).any()
    assert not torch.isfinite(want[:, 0]).any()
    assert _ulps(got[:, 1:], want[:, 1:], 2)


def test_flash_variant_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 128, 2, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):        # a tail the TPU grid would drop
        fv.flash_variant(q, q, q, block_q=64, block_k=96)
    with pytest.raises(TypeError):
        fv.flash_variant(q.float(), q.float(), q.float(), block_q=64,
                         block_k=128)
    for d in (44, 64):     # D a multiple of 8, at most 48
        wide = torch.zeros(1, 128, 2, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            fv.flash_nomax(wide, wide, wide, block_q=64, block_k=128)
    # 16-byte loads: a base 2 bytes off alignment is refused, not read
    off = torch.zeros(128 * 2 * 40 + 1, device=cuda, dtype=torch.bfloat16)
    off = off[1:].view(1, 128, 2, 40)
    with pytest.raises(ValueError):
        fv.flash_variant(off, q, q, block_q=64, block_k=128)


# (name, single-pass, bf16 probabilities, kt, no-max): every mode of
# csrc/flash_variants.cu
FV_MODES = [("single", True, False, False, False),
            ("online", False, False, False, False),
            ("single_bf16", True, True, False, False),
            ("online_bf16", False, True, False, False),
            ("single_kt", True, False, True, False),
            ("online_kt", False, False, True, False),
            ("nomax", True, False, False, True)]


def _fv_call(q, k, v, block_q, single, bf16, kt, nomax):
    """(kernel call, plain version) of one mode; online takes block_k =
    S / 2."""
    s = k.shape[1]
    bk = s if single else s // 2
    if nomax:
        return (lambda: fv.flash_nomax(q, k, v, block_q=block_q, block_k=s),
                lambda: fv.flash_nomax_ref(q, k, v))
    pd = torch.bfloat16 if bf16 else torch.float32
    return (lambda: fv.flash_variant(q, k, v, block_q=block_q, block_k=bk,
                                     prob_dtype=pd, kt=kt),
            lambda: fv.flash_variant_ref(q, k, v, block_k=bk,
                                         bf16_probs=bf16))


@pytest.mark.parametrize("t,s,d,block_q", [
    (96, 320, 24, 32), (96, 320, 40, 96),          # T ragged on 64 rows
    (320, 320, 24, 320), (320, 320, 40, 320),      # T ragged on 128 rows
    (1024, 320, 24, 1024), (1024, 320, 40, 1024)])  # S ragged on 128 keys
@pytest.mark.parametrize("mode", FV_MODES, ids=[m[0] for m in FV_MODES])
def test_flash_variant_kernel_ragged_shapes(cuda, t, s, d, block_q, mode):
    """D 24 and 40 (k16 steps and a k8 tail) at T off the tile's rows and S
    off its keys, in every mode: two bf16 ulps of the plain version."""
    g = torch.Generator(cuda).manual_seed(t + s + d)
    q, k, v = (torch.randn(1, n, 2, d, device=cuda, generator=g)
               .to(torch.bfloat16) for n in (t, s, s))
    run, ref = _fv_call(q, k, v, block_q, *mode[1:])
    got = run()
    torch.cuda.synchronize()
    assert _ulps(got, ref(), 2)


@pytest.mark.parametrize("mode", FV_MODES, ids=[m[0] for m in FV_MODES])
def test_flash_variant_kernel_one_launch_and_the_same_bits(cuda, mode):
    """Each mode: one launch a call on its own counter (flash_variant or
    flash_nomax, the other unmoved) and two calls bit-equal."""
    g = torch.Generator(cuda).manual_seed(17)
    q, k, v = (torch.randn(2, 512, 3, 40, device=cuda, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    run, _ = _fv_call(q, k, v, 512, *mode[1:])
    own, other = ((fv.flash_nomax, fv.flash_variant) if mode[4]
                  else (fv.flash_variant, fv.flash_nomax))
    n_own, n_other = own.launches, other.launches
    a = run()
    b = run()
    torch.cuda.synchronize()
    assert own.launches == n_own + 2 and other.launches == n_other
    assert torch.equal(a, b)


@pytest.mark.parametrize("block_k", [256, 128])
def test_flash_variant_kernel_bf16_probabilities_at_wide_scores(cuda,
                                                                block_k):
    """q scaled by 4 spreads the scores so that rounding s - m to bf16
    moves p: the plain versions with bf16 and fp32 probabilities then
    differ, and single-pass, whose max is the plain version's, must sit far
    closer to the bf16 one (the variant is its rounding point); online
    rescales at other keys than the plain version, so it is held to two
    ulps only."""
    g = torch.Generator(cuda).manual_seed(9)
    q, k, v = (torch.randn(2, 256, 2, 40, device=cuda, generator=g)
               for _ in range(3))
    q, k, v = ((4 * q).to(torch.bfloat16), k.to(torch.bfloat16),
               v.to(torch.bfloat16))
    got = fv.flash_variant(q, k, v, block_q=256, block_k=block_k,
                           prob_dtype=torch.bfloat16)
    want = fv.flash_variant_ref(q, k, v, block_k=block_k, bf16_probs=True)
    torch.cuda.synchronize()
    assert _ulps(got, want, 2)
    if block_k == 256:
        fp32 = fv.flash_variant_ref(q, k, v, block_k=block_k)
        apart = float((fp32.float() - want.float()).abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert apart > 0 and err <= apart / 4, (err, apart)


def test_flash_variant_plans_agree_with_the_c_side(cuda):
    """The C side's plan is `variant_plan` at every sweep variant and at
    small shapes, and both refuse the same calls."""
    from gill_tpu_torch.scripts import attn_sweep

    for shape in (attn_sweep.SHAPE, (1, 1024, 2, 24), (2, 2048, 3, 48)):
        b, s, h, d = shape
        for spec in attn_sweep.VARIANTS:
            _, bq, bk = attn_sweep.build(spec, s)
            mode = (fv.NOMAX if spec[5] else fv.SINGLE if bk == s
                    else fv.ONLINE)
            args = (b, s, s, h, d, mode, spec[3] == "bfloat16", spec[4], bq)
            assert fv.c_plan(*args) == fv.variant_plan(*args)
    for args in [(1, 256, 256, 2, 44, fv.SINGLE, False, False, 64),
                 (1, 256, 256, 2, 40, fv.SINGLE, False, False, 96),
                 (1, 256, 256, 2, 40, fv.NOMAX, True, False, 64),
                 (1, 256, 252, 2, 40, fv.SINGLE, False, True, 64)]:
        with pytest.raises(ValueError):
            fv.variant_plan(*args)
        assert fv.c_plan(*args) is None


@pytest.mark.parametrize("field,value", [("bq", 128), ("bk", 128),
                                         ("stages", 3), ("smem", 1024)])
def test_flash_variant_kernel_refuses_another_plan(cuda, monkeypatch, field,
                                                   value):
    """The entry point launches only the geometry of `variant_plan`: a
    plan with one field changed is refused (an error at launch), and
    nothing is counted."""
    q = torch.zeros(1, 256, 2, 40, device=cuda, dtype=torch.bfloat16)
    plan = fv.variant_plan(1, 256, 256, 2, 40, fv.SINGLE, False, False, 256)
    monkeypatch.setattr(fv, "variant_plan",
                        lambda *a: plan._replace(**{field: value}))
    before = fv.flash_variant.launches
    with pytest.raises(RuntimeError):
        fv.flash_variant(q, q, q, block_q=256, block_k=256)
    assert fv.flash_variant.launches == before


def _k1_tol(want):
    """1e-4 absolute in fp32; two bf16 ulps of the largest output in
    bf16."""
    if want.dtype == torch.float32:
        return 1e-4
    return 2 * 2.0 ** -7 * float(want.float().abs().max())


def _k1_check(got, want):
    assert got.is_contiguous() and got.shape == want.shape
    assert got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= _k1_tol(want), err


# K1's main-path shapes at full size (CLIP ViT-L/14, the OPT-6.7B prefill,
# the UNet's head-dim-160 self- and cross-attention at CFG batch 2, the
# VAE's one 512-wide head), then ragged query / key counts
K1_CASES = [(1, 257, 257, 16, 64, False), (1, 320, 320, 32, 128, True),
            (2, 256, 256, 8, 160, False), (2, 256, 77, 8, 160, False),
            (2, 64, 64, 8, 160, False), (2, 64, 77, 8, 160, False),
            (1, 4096, 4096, 1, 512, False),
            (1, 257, 77, 4, 160, False), (2, 200, 130, 3, 512, False),
            (1, 200, 257, 2, 256, False), (1, 100, 300, 4, 128, True),
            (1, 70, 130, 2, 96, False), (1, 50, 60, 2, 44, True)]


@pytest.mark.parametrize("b,t,s,h,d,causal,dtype", [
    (*case, dt) for case in K1_CASES for dt in ("float32", "bfloat16")
    if dt == "float32" or case[4] > attn.MMA_MAX_HEAD_DIM])
def test_k1_kernel_matches_plain(cuda, b, t, s, h, d, causal, dtype):
    """K1 against `flash_attention_ref` in both dtypes (bf16 at head dims
    above K2's): fp32 on csrc/flash_attn.cu, bf16 on csrc/flash_mma.cu;
    each call counts once on `flash_attention.launches` and never on
    K2's."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(t + s + d)
    q, k, v = (torch.randn(b, n, h, d, device=cuda, generator=g).to(dt)
               for n in (t, s, s))
    fa = attn.flash_attention
    before = (fa.launches, fa.mma_launches)
    got = fa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches, fa.mma_launches) == (before[0] + 1, before[1])
    _k1_check(got, attn.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,kv_len", [(64, 77), (128, 200), (160, 77),
                                      (512, 100)])
def test_k1_kernel_masks_past_kv_len(cuda, d, kv_len, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(d + kv_len)
    q, k, v = (torch.randn(1, n, 2, d, device=cuda, generator=g).to(dt)
               for n in (150, 257, 257))
    got = attn.flash_attention(q, k, v, kv_len=kv_len)
    _k1_check(got, attn.flash_attention_ref(q, k[:, :kv_len], v[:, :kv_len]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,causal", [(64, False), (128, True), (160, False),
                                      (512, False)])
def test_k1_kernel_takes_fused_and_unaligned_views(cuda, d, causal, dtype):
    """Head-split views of one fused (B, T, 3, H, D) projection go in as
    they are; a view whose base is not 16-byte aligned is copied first."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(d)
    qkv = torch.randn(2, 300, 3, 2, d, device=cuda, generator=g).to(dt)
    q, k, v = qkv.unbind(2)
    want = attn.flash_attention_ref(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    _k1_check(attn.flash_attention(q, k, v, causal=causal), want)
    buf = torch.randn(70 * 2 * d + 1, device=cuda, generator=g).to(dt)
    x = buf[1:].view(1, 70, 2, d)
    assert x.data_ptr() % 16 != 0
    _k1_check(attn.flash_attention(x, x, x),
              attn.flash_attention_ref(x, x, x))


def test_unet_call_and_vae_decode_launch_k1_and_k3(cuda):
    """A bf16 UNet with SD v1.5's 320- and 1280-channel levels (8 heads:
    head dims 40 and 160), two levels at a 16 x 16 latent: its 14 attention
    calls take K2 (head dim 40) and K1 (160), its 7 GEGLU FFs K3, and the
    output is finite; a bf16 VAE decoder whose mid block is 512 channels
    wide (one head of 512) decodes a 16 x 16 latent through K1."""
    from gill_tpu_torch import config as tcfg
    from gill_tpu_torch.models.sd import unet, vae
    from gill_tpu_torch.nn.core import Init, tree_map

    fa, gf = attn.flash_attention, geglu.geglu_ff
    cfg = tcfg.UNetConfig(block_out_channels=(320, 1280), layers_per_block=1,
                          down_block_types=("CrossAttnDownBlock2D",) * 2,
                          up_block_types=("CrossAttnUpBlock2D",) * 2)
    g = torch.Generator(cuda).manual_seed(0)
    params = tree_map(lambda x: x.bfloat16(), unet.init(Init(g, cuda), cfg))
    lat = torch.randn(2, 16, 16, 4, device=cuda, generator=g).bfloat16()
    ctx = torch.randn(2, 77, 768, device=cuda, generator=g).bfloat16()
    before = (fa.launches, fa.mma_launches, gf.launches)
    out = unet.apply(params, cfg, lat, torch.tensor(501.0, device=cuda), ctx)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    k1, k2, k3 = (fa.launches - before[0], fa.mma_launches - before[1],
                  gf.launches - before[2])
    assert k1 > 0 and k2 > 0 and k1 + k2 == 14 and k3 == 7
    vcfg = tcfg.VAEConfig(block_out_channels=(64, 512), layers_per_block=1)
    vparams = tree_map(lambda x: x.bfloat16(),
                       vae.init_decoder(Init(g, cuda), vcfg))
    before = fa.launches
    img = vae.decode(vparams, vcfg, lat[:1])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img.float()).all())
    assert fa.launches - before == 1
