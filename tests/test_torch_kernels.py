"""The hand-written CUDA kernels against their plain PyTorch versions on a
GPU. Skipped (with a reason) where no CUDA device is present.

This file imports neither JAX nor gill_tpu, so on a machine with a card and
no JAX it runs on its own, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: fp32 1e-4 absolute (fp32 FMA sums in another order); bf16
attention two bf16 ulps of the largest output (both sides round one fp32
value to bf16); bf16 GEGLU four ulps (the plain version rounds the
projection and the gated product to bf16, the kernel keeps fp32 until the
gated product).
"""

import pytest
import torch

from gill_tpu_torch.ops import attention as attn
from gill_tpu_torch.ops import geglu

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
