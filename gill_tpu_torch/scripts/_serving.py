"""What the serving probes share: the model they build (the originals'
`init_dummy` OPT with zero W8 weights, or a GILLCore around it), the
bench_serve trace, and the engines' steady decode state.

Every probe takes `params` (and the GILL ones `core`) to run on a tree its
caller already holds, as chip_smoke.py hands them its W8 OPT-6.7B; without
them it builds the zero tree of `model` on the device, in bf16 on the card
and in fp32 on the CPU (the plain versions' dtype).
"""

from __future__ import annotations

import numpy as np
import torch

from gill_tpu_torch.config import CLIPVisionConfig, GILLConfig, OPTConfig
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.nn.core import Init

MODEL = "facebook/opt-2.7b"
NUM_TOKENS = 8      # the originals' GILL [IMG] tokens


def act_dtype(device):
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def opt_cfg(model) -> OPTConfig:
    """A preset's name or an OPTConfig (the tests' tiny widths)."""
    return OPTConfig.from_name(model) if isinstance(model, str) else model


def model_name(model) -> str:
    return model if isinstance(model, str) else "custom"


def w8_lm(model, device, params=None):
    """(params, cfg): `params` as given, else `model`'s zero tree with its
    decoder linears in W8 (zero int8 weights)."""
    cfg = opt_cfg(model)
    if params is None:
        params = opt_mod.quantize_params_w8(
            opt_mod.init_dummy(cfg, act_dtype(device), device=device))
    return params, cfg


def gill_model(model, device, core=None, params=None):
    """(core, params): as given, else a GILLCore over `model` with the
    originals' 8 [IMG] tokens and a small vision tower (never run), its LM
    the zero W8 tree with the [IMG] rows appended and zero [IMG]
    embeddings."""
    from gill_tpu_torch.models.gill import GILLCore

    if core is not None:
        return core, params
    cfg = opt_cfg(model)
    nt = NUM_TOKENS
    core = GILLCore(cfg=GILLConfig(opt_version=model_name(model),
                                   num_tokens=nt),
                    opt_cfg=cfg,
                    vis_cfg=CLIPVisionConfig(hidden_size=32,
                                             intermediate_size=64,
                                             num_layers=2, num_heads=2,
                                             image_size=32, patch_size=16),
                    vocab_len=cfg.vocab_size + nt + 1,
                    img_start=cfg.vocab_size + 1, pad_token_id=1,
                    bos_token_id=2)
    lm, _ = w8_lm(model, device)
    lm = opt_mod.resize_embeddings(
        lm, core.vocab_len, Init(torch.Generator(device).manual_seed(0),
                                 device, act_dtype(device)))
    img = torch.zeros((nt, cfg.word_embed_proj_dim), device=device,
                      dtype=act_dtype(device))
    return core, {"lm": lm, "adapters": {"img_embeddings": img}}


def serve_trace(n: int, seed: int = 7, prompt=(16, 241), gen=(16, 193)):
    """bench.py bench_serve's trace: prompt lengths U[16, 240] of random
    ids, generation lengths U[16, 192] (the ranges' ends exclusive)."""
    from gill_tpu_torch.serve.engine import ServeRequest

    rng = np.random.RandomState(seed)
    return [ServeRequest(
        uid=i, prompt=rng.randint(2, 1000, size=int(rng.randint(*prompt)))
        .tolist(), max_new_tokens=int(rng.randint(*gen))) for i in range(n)]


def warm_requests(sizes=(20, 100, 200), new: int = 4):
    """The originals' warm-up requests: prompts of `sizes` fives."""
    from gill_tpu_torch.serve.engine import ServeRequest

    return [ServeRequest(uid=i, prompt=[5] * p, max_new_tokens=new)
            for i, p in enumerate(sizes)]


def steady_lm(eng, pos: int):
    """A DecodeEngine's decode state with every slot busy at `pos` (the
    originals' steady state: token 7, budget to max_seq - 1)."""
    b, dev = eng.slots, eng.device
    eng._dstate = {"pos": torch.full((b,), pos, dtype=torch.int32,
                                     device=dev),
                   "tok": torch.full((b,), 7, dtype=torch.int32, device=dev),
                   "active": torch.ones((b,), dtype=torch.bool, device=dev),
                   "limit": torch.full((b,), eng.max_seq - 1,
                                       dtype=torch.int32, device=dev)}


def steady_gill(eng, pos: int):
    """A GillDecodeEngine's decode state with every slot busy at `pos`
    and a budget no chunk reaches."""
    eng._dstate, eng._dtap = eng._fresh_state()
    st = dict(eng._dstate)
    b, dev = eng.slots, eng.device
    st["pos"] = torch.full((b,), pos, dtype=torch.int32, device=dev)
    st["tok"] = torch.full((b,), 7, dtype=torch.int32, device=dev)
    st["valid"] = torch.ones((b,), dtype=torch.bool, device=dev)
    st["nw"] = torch.full((b,), 10_000, dtype=torch.int32, device=dev)
    eng._dstate = st


# Where two decode paths of the card's bf16 arithmetic disagree on a greedy
# token, the probes hold the disagreement to a near-tie: the top-2 logits
# at its first divergent position, recomputed by one plain forward of the
# shared sequence, lie within TIE_RTOL of the largest logit (the bound
# chip_smoke.py's phase A holds one W8 decode step's logits to against the
# plain versions). A divergence above it fails the probe's row. In fp32
# (the CPU tests) the paths agree exactly.
TIE_RTOL = 3e-2


def first_diff(a, b) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def tie_margin(logits) -> float:
    """The top-2 gap of logits (V,) over their largest magnitude."""
    x = logits.float()
    top = torch.topk(x, 2).values
    return float((top[0] - top[1]) / x.abs().max().clamp_min(1e-30))


def lm_tie_margin(params, cfg, ids) -> float:
    """`tie_margin` of the next-token logits after `ids` (one plain forward
    of the whole sequence, the tied fp32 head)."""
    dev = params["embed_tokens"]["weight"].device
    emb = opt_mod.embed_tokens(params, torch.tensor([ids], device=dev))
    head = params["embed_tokens"]["weight"].float()
    out = opt_mod.forward(params, cfg, emb, lm_head=head)
    return tie_margin(out["logits"][0, -1])


def token_divergences(params, cfg, a: dict, b: dict, prompts: dict) -> list:
    """For each uid whose token lists in `a` and `b` differ: where they
    first differ and that position's `lm_tie_margin`."""
    out = []
    for u in sorted(a):
        if a[u] == b.get(u):
            continue
        d = first_diff(a[u], b[u])
        out.append({"uid": u, "at": d, "margin": lm_tie_margin(
            params, cfg, list(prompts[u]) + list(a[u][:d]))})
    return out


def unexplained(divergences) -> list:
    return [x for x in divergences if x["margin"] > TIE_RTOL]
