"""The SD UNet's non-default modes and the DDIM / DPM-Solver++ samplers of
gill_tpu_torch against gill_tpu.

The tiny UNet's weights come from the port's init and reach gill_tpu in its
layout through weights/from_jax.tree_to_numpy. On the CPU the port's
FUSE_LN and q8 branches run their kernels' plain versions; gill_tpu takes
neither branch off a TPU, so it computes the unfused, unquantized function.

Tolerances: FUSE_LN fp32 1e-5 relative to the output scale (the folded
LayerNorm is the same function; products summed in another order); bf16
3e-2, test_torch_sd.py's UNet bound (the folded LayerNorm squares in fp32
where nn.layer_norm squares in bf16: a variance ulp). q8 against the
unquantized UNet: 1e-2 relative to the output scale, about ten times the
measured 6e-4 (int8 q/k move the attention scores by ~1e-2 of their
range). Samplers: DDIM steps 1e-5 relative, DPM++ 2e-4 against the numpy
port of diffusers (test_sd.py's bound), 1e-5 against gill_tpu's steps. The
int8 pipeline, teacher-forced step by step against gill_tpu's unet.apply
and PNDM steps on the same quantized weights: see its test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.models.sd import unet as junet
from gill_tpu.models.sd.scheduler import DDIMScheduler as JDDIM
from gill_tpu.models.sd.scheduler import DPMSolverPPScheduler as JDPM
from gill_tpu.models.sd.scheduler import PNDMScheduler as JPNDM
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.sd import unet as tunet
from gill_tpu_torch.models.sd import vae as tvae
from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
from gill_tpu_torch.models.sd.scheduler import DDIMScheduler as TDDIM
from gill_tpu_torch.models.sd.scheduler import DPMSolverPPScheduler as TDPM
from gill_tpu_torch.nn.core import Init, tree_map
from gill_tpu_torch.weights.from_jax import tree_to_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _unet_case():
    cfg = tcfg.tiny_unet_config()
    tp = tunet.init(Init(torch.Generator().manual_seed(10), "cpu"), cfg)
    rng = np.random.RandomState(10)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 5, cfg.cross_attention_dim).astype(np.float32)
    return tp, tree_to_numpy(tp), lat, ctx


@functools.lru_cache(maxsize=None)
def _gill_tpu_unet(dtype):
    _, jp, lat, ctx = _unet_case()
    jdt = getattr(jnp, dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), jp)
    cfg = junet.tiny_unet_config()
    out = jax.jit(functools.partial(junet.apply, cfg=cfg))(
        jp, latents=jnp.asarray(lat, jdt), timesteps=jnp.asarray(501.0),
        encoder_hidden_states=jnp.asarray(ctx, jdt))
    return np.asarray(out.astype(jnp.float32))


def _port_unet(dtype, **kw):
    tp, _, lat, ctx = _unet_case()
    tdt = getattr(torch, dtype)
    params = tree_map(lambda t: t.to(tdt), tp)
    return tunet.apply(params, tcfg.tiny_unet_config(),
                       torch.from_numpy(lat).to(tdt), torch.tensor(501.0),
                       torch.from_numpy(ctx).to(tdt), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_unet_matches_gill_tpu(monkeypatch, dtype):
    """FUSE_LN routes self-attention through the stacked LN-matmul, the
    cross-attention q through the LN-matmul and the feed-forwards through
    the LN-folded GEGLU (plain versions on the CPU)."""
    from gill_tpu_torch.ops import ln_matmul

    calls = []
    for name in ("ln_matmul", "ln_matmul_stacked"):
        fn = getattr(ln_matmul, name)
        monkeypatch.setattr(ln_matmul, name, lambda *a, _fn=fn, _n=name,
                            **k: calls.append(_n) or _fn(*a, **k))
    monkeypatch.setattr(tunet, "FUSE_LN", True)
    got = _port_unet(dtype)
    # the tiny UNet's four transformer blocks: one self and one cross each
    assert sorted(calls) == ["ln_matmul"] * 4 + ["ln_matmul_stacked"] * 4
    assert got.dtype == getattr(torch, dtype)
    _close(got, _gill_tpu_unet(dtype), 1e-5 if dtype == "float32" else 3e-2)


def test_q8_unet_within_quantization_bound_of_gill_tpu(monkeypatch):
    from gill_tpu_torch.ops import attention

    calls = []
    fn = attention.flash_attention_q8
    monkeypatch.setattr(attention, "flash_attention_q8",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    got = _port_unet("float32", q8=True)
    assert len(calls) == 8                  # 4 blocks x (self + cross)
    want = _gill_tpu_unet("float32")
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert 0 < err < 1e-2, err


def test_fused_ln_with_q8_keeps_the_unfused_attention(monkeypatch):
    """gill_tpu's gate: FUSE_LN's attention fold is off under q8, the
    feed-forward fold stays."""
    from gill_tpu_torch.ops import ln_matmul

    monkeypatch.setattr(tunet, "FUSE_LN", True)
    monkeypatch.setattr(ln_matmul, "ln_matmul", None)
    monkeypatch.setattr(ln_matmul, "ln_matmul_stacked", None)
    a = _port_unet("float32", q8=True)
    monkeypatch.setattr(tunet, "FUSE_LN", False)
    _close(a, _port_unet("float32", q8=True).numpy(), 1e-5)


def test_stacked_qkv_is_built_once_per_tree():
    tp, _, _, _ = _unet_case()
    p = tp["down"][0]["attns"][0]["block"]["attn1"]
    a = tunet._stacked_qkv(p, torch.float32)
    assert tunet._stacked_qkv(p, torch.float32) is a
    assert tuple(a.shape) == (3,) + tuple(p["q"]["w"].shape)
    b = tunet._stacked_qkv(p, torch.bfloat16)
    assert b.dtype == torch.bfloat16 and b is not a
    q = dict(p, k={"w": p["k"]["w"].clone()})      # another tree's k
    assert tunet._stacked_qkv(q, torch.bfloat16) is not b


def test_ddim_recovers_x0_on_analytic_eps():
    """Mirrors gill_tpu's test: with the exact noise as the model output,
    DDIM walks back to x0 (set_alpha_to_one=False leaves ~3% noise)."""
    sch = TDDIM()
    x0 = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 4, 2)).float()
    noise = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 4, 2)).float()
    ts, ratio = sch.timesteps(50)
    acp = sch.acp
    sample = acp[ts[0]] ** 0.5 * x0 + (1 - acp[ts[0]]) ** 0.5 * noise
    state = sch.init_state(sample)
    for t in ts:
        eps = (sample - acp[t] ** 0.5 * x0) / torch.clamp(
            (1 - acp[t]) ** 0.5, min=1e-8)
        sample, state = sch.step(state, eps, t, sample, ratio)
    np.testing.assert_allclose(sample.numpy(), x0.numpy(), atol=0.1)


def test_ddim_steps_match_gill_tpu():
    js, ts_ = JDDIM(), TDDIM()
    jt, jr = js.timesteps(20)
    tt, tr = ts_.timesteps(20)
    assert tt == [int(x) for x in np.asarray(jt)] and tr == jr
    rng = np.random.RandomState(3)
    x = rng.randn(1, 4, 4, 2).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for t in tt:
        eps = rng.randn(1, 4, 4, 2).astype(np.float32)
        jx, _ = js.step({}, jnp.asarray(eps), jnp.asarray(t), jx, jr)
        tx, _ = ts_.step({}, torch.from_numpy(eps), t, tx, tr)
        _close(tx, jx, 1e-5)


@pytest.mark.parametrize("n_steps", [8, 20, 25, 50])
def test_dpmpp_matches_gill_tpu_and_numpy_port(n_steps):
    """Mirrors test_dpmpp_matches_numpy_port (the diffusers-structured numpy
    trajectory, 2e-4) and holds every step against gill_tpu's (1e-5):
    timesteps, next timesteps, first- and second-order updates and the
    lower-order final step below 15 steps."""
    from test_sd import _np_dpmpp_2m_trajectory

    js, ts_ = JDPM(), TDPM()
    jt, _ = js.timesteps(n_steps)
    jpt = js.prev_timesteps(jt)
    tt, ratio = ts_.timesteps(n_steps)
    tpt = ts_.prev_timesteps(tt)
    assert tt == [int(x) for x in np.asarray(jt)]
    assert tpt == [int(x) for x in np.asarray(jpt)]
    acp = np.asarray(js.acp, np.float64)
    rng = np.random.RandomState(0)
    w = rng.randn(4, 4) * 0.1

    def eps_np(x, t):
        return np.tanh(x @ w) + 1e-3 * t / 1000.0

    x0 = rng.randn(2, 4)
    ref = _np_dpmpp_2m_trajectory(eps_np, x0.copy(), n_steps, acp)
    jstate = js.init_state(x0.shape, jnp.float32)
    tstate = ts_.init_state(torch.zeros(2, 4))
    jx = jnp.asarray(x0, jnp.float32)
    tx = torch.from_numpy(x0).float()
    for t, pt in zip(tt, tpt):
        eps = eps_np(tx.double().numpy(), t).astype(np.float32)
        jx, jstate = js.step(jstate, jnp.asarray(eps), jnp.asarray(t), jx,
                             ratio, prev_timestep=jnp.asarray(pt))
        tx, tstate = ts_.step(tstate, torch.from_numpy(eps), t, tx, ratio,
                              prev_timestep=pt)
        _close(tx, jx, 1e-5)
    np.testing.assert_allclose(tx.numpy(), ref, rtol=2e-4, atol=2e-4)


def _tiny_pipe(**kw):
    cfg = tcfg.tiny_sd_config()
    init = Init(torch.Generator().manual_seed(0), "cpu")
    params = {"unet": tunet.init(init, cfg.unet),
              "vae_decoder": tvae.init_decoder(init, cfg.vae)}
    return StableDiffusionPipeline(cfg, params, **kw)


def test_dpmpp_in_pipeline_tiny():
    """Mirrors gill_tpu's test: the dpm++ sampler through the tiny
    pipeline gives a finite image."""
    pipe = _tiny_pipe(sampler="dpm++")
    cfg = pipe.cfg
    emb = torch.randn(1, cfg.text.max_positions, cfg.unet.cross_attention_dim,
                      generator=torch.Generator().manual_seed(0))
    img = pipe(prompt_embeds=emb, num_inference_steps=4, guidance_scale=3.0,
               generator=torch.Generator().manual_seed(1))
    assert tuple(img.shape) == (1, cfg.default_size, cfg.default_size, 3)
    assert bool(torch.isfinite(img).all())
    with pytest.raises(ValueError):
        _tiny_pipe(sampler="euler")


def test_quantized_pipeline_runs_in_its_bias_dtype():
    """The int8 UNet has no conv_in "w": the pipeline takes the UNet's
    dtype from conv_in's bias (gill_tpu raises KeyError here) and
    generates a finite image."""
    pipe = _tiny_pipe(quantize=True)
    assert pipe.quantized and "w" not in pipe.params["unet"]["conv_in"]
    cfg = pipe.cfg
    emb = torch.randn(1, cfg.text.max_positions, cfg.unet.cross_attention_dim,
                      generator=torch.Generator().manual_seed(0))
    img = pipe(prompt_embeds=emb, num_inference_steps=3,
               generator=torch.Generator().manual_seed(2))
    assert tuple(img.shape) == (1, cfg.default_size, cfg.default_size, 3)
    assert bool(torch.isfinite(img).all())


def test_int8_pipeline_matches_a_gill_tpu_loop(monkeypatch):
    """gill_tpu's own quantized pipeline raises (its dtype rule reads
    conv_in["w"]), so the reference is a loop over gill_tpu's unet.apply on
    the same quantized weights and its PNDM steps, teacher-forced on the
    port's recorded UNet inputs and outputs:
      * each UNet call against gill_tpu's on the same input, within 5e-2
        relative to the output scale: an int8 activation that lies within
        float rounding of a .5 boundary can round the other way in the two
        packages (their timestep embeddings' sin/cos differ in the last
        bit), and one such flip moves this tiny random UNet's output by up
        to 4.6e-2 (measured here with 3 steps at t = 667; the other calls
        agree to 3e-7). test_torch_quant.py holds the int8 UNet at 1e-5 where no
        value sits on a boundary;
      * the guidance and each PNDM step, from the port's own noise
        prediction, against gill_tpu's: 1e-5 relative, to the final
        latents."""
    from gill_tpu_torch.models.sd import pipeline as tpipe

    pipe = _tiny_pipe(quantize=True)
    cfg = pipe.cfg
    rng = np.random.RandomState(6)
    nct, cd = cfg.text.max_positions, cfg.unet.cross_attention_dim
    emb = rng.randn(1, nct, cd).astype(np.float32)
    lat = rng.randn(1, 8, 8, 4).astype(np.float32)
    calls = []
    port_apply = tpipe.unet_mod.apply

    def recording(params, ucfg, x, t, ctx, **kw):
        out = port_apply(params, ucfg, x, t, ctx, **kw)
        calls.append((x.numpy().copy(), float(t), out.numpy().copy()))
        return out

    monkeypatch.setattr(tpipe.unet_mod, "apply", recording)
    got = pipe(prompt_embeds=torch.from_numpy(emb),
               latents=torch.from_numpy(lat), num_inference_steps=3,
               output_latents=True)

    jqp = tree_to_numpy(pipe.params["unet"])
    apply = jax.jit(functools.partial(junet.apply, cfg=junet.tiny_unet_config()))
    sch = JPNDM()
    ts, ratio = sch.timesteps(3)
    state = sch.init_state(lat.shape)
    ctx = jnp.concatenate([jnp.zeros((1, nct, cd)), jnp.asarray(emb)])
    assert [c[1] for c in calls] == [float(t) for t in np.asarray(ts)]
    np.testing.assert_array_equal(calls[0][0], np.concatenate([lat, lat]))
    for i, t in enumerate(np.asarray(ts)):
        x_in, _, eps_port = calls[i]
        eps = np.asarray(apply(jqp, latents=jnp.asarray(x_in),
                               timesteps=jnp.asarray(float(t)),
                               encoder_hidden_states=ctx))
        assert np.abs(eps_port - eps).max() <= 5e-2 * np.abs(eps).max()
        eps_u, eps_t = np.split(eps_port, 2)
        guided = jnp.asarray(eps_u + 7.5 * (eps_t - eps_u))
        x, state = sch.step(state, guided, jnp.asarray(int(t)),
                            jnp.asarray(x_in[:1]), ratio)
        nxt = calls[i + 1][0][:1] if i + 1 < len(calls) else got
        _close(torch.as_tensor(nxt), x, 1e-5)
