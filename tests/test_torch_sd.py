"""gill_tpu_torch's Stable Diffusion stack against gill_tpu's: PNDM
scheduler values, the tiny UNet and the tiny VAE decoder, with gill_tpu's
random parameters carried into the port by weights/from_jax.py.

Tolerances: fp32 1e-4 relative to the output scale (a few dozen layers,
GroupNorm statistics summed in another order); bf16 3e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.models.sd import unet as junet
from gill_tpu.models.sd import vae as jvae
from gill_tpu.models.sd.scheduler import PNDMScheduler as JPNDM
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.sd import unet as tunet
from gill_tpu_torch.models.sd import vae as tvae
from gill_tpu_torch.models.sd.scheduler import PNDMScheduler as TPNDM
from gill_tpu_torch.weights import from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _np(tree):
    return jax.device_get(tree)


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_pndm_schedule_and_steps_match_gill_tpu():
    """Timesteps, alphas and six PLMS steps (warm-up, 1.5-order, orders
    2-4) on the same model outputs. fp32 cumulative products over 1000
    terms differ in the last bits: 1e-5 relative."""
    js, ts = JPNDM(), TPNDM()
    jt, jr = js.timesteps(50)
    tt, tr = ts.timesteps(50)
    assert tt == [int(x) for x in np.asarray(jt)] and tr == jr
    np.testing.assert_allclose(ts.acp.numpy(), np.asarray(js.acp), rtol=1e-5)
    rng = np.random.RandomState(9)
    sample = rng.randn(1, 4, 4, 2).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    jstate = js.init_state(sample.shape)
    tstate = ts.init_state(tsample)
    for t in tt[:6]:
        eps = rng.randn(1, 4, 4, 2).astype(np.float32)
        jsample, jstate = js.step(jstate, jnp.asarray(eps), jnp.asarray(t),
                                  jsample, jr)
        tsample, tstate = ts.step(tstate, torch.from_numpy(eps), t, tsample,
                                  tr)
        _close(tsample, jsample, 1e-5)


@functools.lru_cache(maxsize=None)
def _unet_case():
    cfg = junet.tiny_unet_config()
    p = _np(junet.init(jax.random.PRNGKey(10), cfg))
    rng = np.random.RandomState(10)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 5, cfg.cross_attention_dim).astype(np.float32)
    return cfg, p, lat, ctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_unet_matches_gill_tpu(dtype):
    """fp32: 1e-4 relative to the output scale. bf16 (the pipeline's
    dtype): rounding at different places through ~40 bf16 ops; 3e-2."""
    cfg, p, lat, ctx = _unet_case()
    jdt = getattr(jnp, dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p)
    apply = jax.jit(functools.partial(junet.apply, cfg=cfg))
    want = apply(jp, latents=jnp.asarray(lat, jdt),
                 timesteps=jnp.asarray(501.0),
                 encoder_hidden_states=jnp.asarray(ctx, jdt))
    tdt = getattr(torch, dtype)
    got = tunet.apply(from_jax.unet_from_jax(p, dtype=tdt),
                      tcfg.tiny_unet_config(), torch.from_numpy(lat).to(tdt),
                      torch.tensor(501.0), torch.from_numpy(ctx).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, 8, 8, 4)
    _close(got, want.astype(jnp.float32), 1e-4 if dtype == "float32" else 3e-2)


def test_tiny_vae_decode_matches_gill_tpu():
    cfg = jvae.tiny_vae_config()
    p = _np(jvae.init_decoder(jax.random.PRNGKey(11), cfg))
    lat = np.random.RandomState(11).randn(1, 4, 4, 4).astype(np.float32)
    want = jax.jit(functools.partial(jvae.decode, cfg=cfg))(
        p, latents=jnp.asarray(lat))
    got = tvae.decode(from_jax.vae_decoder_from_jax(p), tcfg.tiny_vae_config(),
                      torch.from_numpy(lat))
    assert tuple(got.shape) == (1, 8, 8, 3)
    _close(got, want, 1e-4)
