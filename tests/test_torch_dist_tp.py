"""Tensor-parallel decoding and serving of the port against gill_tpu's
(tests/test_tp_decode.py's case, widened to 8 heads so tp 2, 4 and 8
divide them).

fp32 on the CPU: at tp 2 and tp 4 (gloo groups of CPU processes, mesh
(1, tp)) `GILLCore.generate` gives tokens equal to gill_tpu's, both its
single-device decode and its decode under `create_mesh(1, 8)`, with
hidden states within 2e-4 at the valid steps (test_tp_decode.py's
tolerance); at tp 2
`DecodeEngine(mesh=)` (run with a registered prefix, and run_pipelined)
and `GillDecodeEngine(mesh=)` (an embedding prefix) give tokens equal to
gill_tpu's engines, the GILL engine's [IMG] hidden runs within 2e-4, and
every rank returns the same. One decode step under the collective
recorder (scripts/tp_collective_budget.py) issues two fp32 all-reduces a
layer of (slots, hidden) over the tp ranks and nothing else, its logits
and tokens unchanged by the recorder. W8 leaves and an int8 pool under a
mesh raise with gill_tpu's messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.config import CLIPVisionConfig, GILLConfig, OPTConfig
from gill_tpu.models.gill import GILLCore as JCore
from gill_tpu.parallel import create_mesh as jmesh
from gill_tpu.parallel import param_shardings
from gill_tpu.parallel.partition import replicated
from gill_tpu.serve.engine import DecodeEngine as JEngine
from gill_tpu.serve.engine import ServeRequest as JRequest
from gill_tpu.serve.gill_engine import GillDecodeEngine as JGEngine
from gill_tpu.serve.gill_engine import GillServeRequest as JGRequest
from gill_tpu_torch.parallel import Mesh
from gill_tpu_torch.weights import from_jax

import torch_dist_cases as cases

OPT = dict(vocab_size=64, hidden_size=32, ffn_dim=64, num_layers=2,
           num_heads=8, word_embed_proj_dim=32, max_positions=96)
VIS = dict(hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
           image_size=16, patch_size=8)
CFG = dict(n_visual_tokens=2, num_tokens=4, num_clip_tokens=6,
           ret_emb_dim=8, gen_emb_dim=12)
IDS = dict(vocab_len=69, img_start=65, pad_token_id=1, bos_token_id=2)
CORE_KW = {"opt": OPT, "vis": VIS, "cfg": CFG, "ids": IDS}
WORDS = 6
ENGINE_KW = dict(slots=3, max_seq=64, chunk=3, prefill_buckets=(8, 16, 32))
GILL_ENGINE_KW = dict(slots=3, max_seq=64, chunk=3, prefill_buckets=(8, 32))
TOL = 2e-4


def _jcore():
    return JCore(cfg=GILLConfig(**CFG), opt_cfg=OPTConfig(**OPT),
                 vis_cfg=CLIPVisionConfig(**VIS), **IDS)


@pytest.fixture(scope="module")
def ref():
    """gill_tpu's decode (one device and mesh (1, 8)) and engines."""
    core = _jcore()
    params = cases.make_params(CORE_KW, 3)
    rng = np.random.RandomState(0)
    embs = (rng.randn(2, 4, 32) * 0.02).astype(np.float32)
    out1 = core.generate(params, jnp.asarray(embs), num_words=WORDS,
                         temperature=0.0)
    mesh = jmesh(dp_size=1, tp_size=8)
    params_s = jax.device_put(params, param_shardings(mesh, params))
    with jax.sharding.set_mesh(mesh):
        out8 = core.generate(params_s, jax.device_put(
            jnp.asarray(embs), replicated(mesh)), num_words=WORDS,
            temperature=0.0)
    trace = [(u, rng.randint(3, 60, size=int(rng.randint(3, 12))).tolist(),
              int(rng.randint(2, 9))) for u in range(7)]
    prefix = rng.randint(3, 60, size=9).tolist()
    trace = [(u, prefix + p if u % 2 else p, n) for u, p, n in trace]
    je = JEngine(params["lm"], OPTConfig(**OPT), unroll_layers=False,
                 kv_dtype=jnp.float32, **ENGINE_KW)
    pid = je.register_prefix(prefix)
    engine = je.run([JRequest(uid=u, prompt=p, max_new_tokens=n,
                              prefix_id=pid if u % 2 else None)
                     for u, p, n in trace])
    gill_prefix = (rng.randn(7, 32) * 0.02).astype(np.float32)
    gill_cases = [dict(uid=u, embs=(rng.randn(int(rng.randint(1, 8)), 32)
                                    * 0.02).astype(np.float32),
                       num_words=int(rng.randint(2, 7)),
                       img_scale=100.0 if u % 2 == 0 else 1.0)
                  for u in range(5)]
    jg = JGEngine(core, params, unroll_layers=False, kv_dtype=jnp.float32,
                  **GILL_ENGINE_KW)
    gpid = jg.register_prefix(gill_prefix)
    gill = jg.run([JGRequest(prefix_id=gpid, **c) for c in gill_cases])
    return {"params": params, "embs": embs,
            "tokens1": np.asarray(out1["tokens"]),
            "hidden1": np.asarray(out1["hidden"]),
            "tokens8": np.asarray(out8["tokens"]),
            "hidden8": np.asarray(out8["hidden"]),
            "valid": np.asarray(out1["valid"]),
            "trace": trace, "prefix": prefix, "engine": engine,
            "gill_prefix": gill_prefix, "gill_cases": gill_cases,
            "gill": gill}


def _serve(ref, tmp_path, tp):
    return cases.run("tp_serve", tp, tmp_path, core_kw=CORE_KW, seed=3,
                     embs=ref["embs"], num_words=WORDS,
                     trace=ref["trace"], prefix=ref["prefix"],
                     gill_cases=ref["gill_cases"],
                     gill_prefix=ref["gill_prefix"], engine_kw=ENGINE_KW,
                     gill_engine_kw=GILL_ENGINE_KW)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_and_engines_match_gill_tpu(ref, tmp_path, tp):
    res = _serve(ref, tmp_path, tp)
    np.testing.assert_array_equal(ref["tokens1"], ref["tokens8"])
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["tokens"], ref["tokens1"])
        np.testing.assert_array_equal(out["tokens"], ref["tokens8"])
        # hidden states at the valid steps (the port's loop stops once
        # every row is done and leaves zeros after)
        v = ref["valid"]
        np.testing.assert_allclose(out["hidden"][v], ref["hidden1"][v],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out["hidden"][v], ref["hidden8"][v],
                                   atol=TOL, rtol=TOL)
        assert out["kv_heads"] == 8 // tp
        assert out["engine"] == ref["engine"], f"rank {r}"
        assert out["engine_pipelined"] == ref["engine"], f"rank {r}"
        assert set(out["gill_engine"]) == set(ref["gill"])
        for u, want in ref["gill"].items():
            got = out["gill_engine"][u]
            assert got["tokens"] == want["tokens"], (r, u)
            np.testing.assert_allclose(got["img_runs"], want["img_runs"],
                                       atol=TOL)
        for k in ("tokens", "hidden"):
            np.testing.assert_array_equal(out[k], res[0][k])
        c = out["collectives"]
        assert [{k: v for k, v in row.items() if k != "ms"}
                for row in c["rows"]] == [{
                    "kind": "all_reduce", "dtype": "float32",
                    "bytes": 3 * OPT["hidden_size"] * 4, "group": tp,
                    "count": 2 * OPT["num_layers"]}]
        assert c["collectives"] == c["all_reduces"] == 2 * OPT["num_layers"]
        assert c["tokens_equal_with_recorder"]
        assert c["logits_equal_with_recorder"]
    assert any(65 in g["tokens"] for g in ref["gill"].values())


def test_mesh_refuses_w8_and_int8_kv(ref):
    """gill_tpu/serve/engine.py:192-204: int8 KV and W8 weights are
    single-chip modes (raised before any collective)."""
    from gill_tpu_torch.models import opt as topt
    from gill_tpu_torch.serve.engine import DecodeEngine

    mesh = Mesh({"data": 1, "model": 2}, 0, (0, 0))
    lm = from_jax.opt_from_jax(ref["params"]["lm"])
    cfg = cases.make_core(CORE_KW).opt_cfg
    with pytest.raises(ValueError, match="int8 KV is a single-chip"):
        DecodeEngine(lm, cfg, mesh=mesh, kv_dtype=torch.int8, slots=2,
                     max_seq=32)
    with pytest.raises(ValueError, match="mesh mode requires bf16"):
        DecodeEngine(topt.quantize_params_w8(lm), cfg, mesh=mesh, slots=2,
                     max_seq=32)
    core = cases.make_core(CORE_KW, mesh)
    with pytest.raises(ValueError, match="int8 KV is a single-chip"):
        core.generate(from_jax.gill_params_from_jax(ref["params"]),
                      torch.zeros(1, 2, 32), num_words=2, kv_int8=True)
    with pytest.raises(ValueError, match="mesh mode requires bf16"):
        topt.forward(topt.quantize_params_w8(lm), cfg, torch.zeros(1, 2, 32),
                     mesh=mesh)


def test_single_device_mesh_is_the_plain_path(ref):
    """The (1, 1) mesh of one process (the CLI's without a launcher) takes
    no collective and refuses nothing: a W8 forward and an int8-KV decode
    give exactly the mesh-less results."""
    from gill_tpu_torch.models import opt as topt
    from gill_tpu_torch.parallel import create_mesh

    mesh = create_mesh()
    lm8 = topt.quantize_params_w8(from_jax.opt_from_jax(ref["params"]["lm"]))
    cfg = cases.make_core(CORE_KW).opt_cfg
    x = torch.from_numpy(ref["embs"])
    torch.testing.assert_close(topt.forward(lm8, cfg, x, mesh=mesh),
                               topt.forward(lm8, cfg, x), rtol=0, atol=0)
    params = from_jax.gill_params_from_jax(ref["params"])
    want, got = (cases.make_core(CORE_KW, m).generate(
        params, x, num_words=3, kv_int8=True) for m in (None, mesh))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
