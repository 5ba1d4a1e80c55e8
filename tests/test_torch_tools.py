"""The port's data and decision scripts (gill_tpu_torch/scripts/
process_p2_annotations, prune_model_ckpt, preprocess_sd_embeddings,
generate_sd_p2_images, train_decision_classifier, validate_real_weights)
against gill_tpu's own scripts on the same inputs, on the CPU.

gill_tpu's scripts are imported by path and run through their `main()`
with `sys.argv` set; where they need a model, their `load_gill` hands
over the tiny model of tests/torch_app_models.py, the port's scripts the
same one with the parameters carried over. Tolerances:
  * the P2 filter's file and the pruned `.npz`: equal, key for key;
  * SD text embeddings (tiny text tower, gill_tpu's PRNGKey(0) weights):
    1e-5 in fp32, the saved fp16 files within one fp16 ulp;
  * P2 images on shared latents: 1e-4 on [0, 1] pixels;
  * the decision features ([IMG0] hidden states): 1e-5; `macro_f1`
    equal; one AdamW step with dropout off within 1e-6 of optax.adamw's;
  * validate_real_weights: the same check names, each SKIPPED with a
    reason without assets; its OPT / CLIP / SD / LPIPS / tokenizer /
    specdec checks PASS on tests/test_validate_real_weights.py's
    synthetic assets.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_app_models as apps

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# P2 annotations, checkpoint pruning
# ---------------------------------------------------------------------------

def test_p2_filter_matches_gill_tpu(tmp_path, monkeypatch):
    from gill_tpu_torch.scripts import process_p2_annotations as p2

    rng = np.random.RandomState(0)
    with open(tmp_path / "in.tsv", "w") as f:
        f.write("Prompt\tCategory\tDecisions\n")
        for i in range(40):
            votes = rng.choice(["gen", "ret", "same"], 5,
                               p=[0.45, 0.45, 0.1])
            f.write(f"prompt {i}\tcat{i % 3}\t{','.join(votes)}\n")
    apps.run_jax(monkeypatch, "scripts/process_p2_annotations.py",
             ["--in", str(tmp_path / "in.tsv"), "--out",
              str(tmp_path / "j.tsv")])
    counts = p2.filter_annotations(str(tmp_path / "in.tsv"),
                                   str(tmp_path / "t.tsv"))
    want = open(tmp_path / "j.tsv").read()
    assert open(tmp_path / "t.tsv").read() == want
    assert want.startswith("Prompt\tCategory\tDecision\n")
    assert set(counts) == {"gen", "ret", "same"}
    jp2 = apps.jax_script("scripts/process_p2_annotations.py")
    for votes in (["gen"] * 4 + ["ret"], ["gen"] * 3 + ["same"] * 2,
                  ["ret"] * 3 + ["gen"] * 2, ["gen", "ret"] * 2 + ["same"]):
        assert p2.majority_vote(votes) == jp2.majority_vote(votes)


def test_pruned_checkpoint_matches_gill_tpu(tmp_path, monkeypatch):
    """A port training run's checkpoint (ckpt/ and ckpt_best/, with its
    optimizer state) pruned by both scripts."""
    from gill_tpu_torch.scripts import prune_model_ckpt
    from gill_tpu_torch.utils.ckpt import save_checkpoint

    rng = np.random.RandomState(1)
    adapters = {"visual_fc": {"w": rng.randn(4, 3).astype(np.float32),
                              "b": rng.randn(3).astype(np.float32)},
                "logit_scale": np.float32(2.5),
                "gen_fc": {"layers": ({"w": rng.randn(2, 2)},
                                      {"w": rng.randn(2, 2)})}}
    state = {"adapters": adapters,
             "opt_state": {"mu": adapters, "count": np.int32(3)}}
    run = str(tmp_path / "run")
    save_checkpoint(state, run, step=3, is_best=True)
    state["adapters"] = {**adapters, "logit_scale": np.float32(9.0)}
    save_checkpoint(state, run, step=4)          # ckpt/ moves on
    apps.run_jax(monkeypatch, "scripts/prune_model_ckpt.py", [run])
    want = dict(np.load(os.path.join(run, "pretrained_ckpt.npz")))
    os.remove(os.path.join(run, "pretrained_ckpt.npz"))
    path = prune_model_ckpt.main([run])
    got = dict(np.load(path))
    assert sorted(got) == sorted(want)
    assert not any(k.startswith("opt_state") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert float(got["logit_scale"]) == 2.5            # ckpt_best/ first


# ---------------------------------------------------------------------------
# SD text embeddings, P2 images
# ---------------------------------------------------------------------------

def _tsv(path, n):
    with open(path, "w") as f:
        f.write("caption\timage\n")
        for i in range(n):
            f.write(f"a photo of thing {i} on a table\timg{i}.jpg\n")
    return str(path)


def test_sd_embeddings_match_gill_tpu(tmp_path, monkeypatch):
    """gill_tpu's script on the tiny SD config (random text tower,
    PRNGKey(0), tiny tokenizer) against the port's on the same weights."""
    import gill_tpu.models.sd.pipeline as jpipe_mod
    from gill_tpu.models import clip as jclip
    from gill_tpu_torch.config import tiny_sd_config
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.scripts import preprocess_sd_embeddings as pre
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer
    from gill_tpu_torch.weights.from_jax import clip_text_from_jax

    jcfg = jpipe_mod.tiny_sd_config()
    monkeypatch.setattr(jpipe_mod, "SDPipelineConfig", lambda: jcfg)
    want = []           # the script's fp32 embeddings, a batch a call

    class Recorded(jpipe_mod.StableDiffusionPipeline):
        def __call__(self, *a, **kw):
            out = super().__call__(*a, **kw)
            want.append(np.asarray(out))
            return out

    monkeypatch.setattr(jpipe_mod, "StableDiffusionPipeline", Recorded)
    tsv = _tsv(tmp_path / "caps.tsv", 5)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(os.path.join(jdir, "clip_embs"))
    np.save(os.path.join(jdir, "clip_embs", "img0.jpg.npy"),
            np.zeros((1,), np.float16))                 # skipped: exists
    apps.run_jax(monkeypatch, "scripts/preprocess_sd_embeddings.py",
             ["--tsv", tsv, "--image-dir", jdir, "--sd-dir",
              str(tmp_path / "none"), "--batch-size", "2"])
    jtext = jclip.init_text(jax.random.PRNGKey(0), jcfg.text)
    pipe = StableDiffusionPipeline(
        tiny_sd_config(), {"unet": None, "vae_decoder": None,
                           "text_encoder": clip_text_from_jax(
                               jax.device_get(jtext))},
        tokenizer=CLIPBPETokenizer.tiny())
    out_dir = os.path.join(tdir, "clip_embs")
    os.makedirs(out_dir)
    pre.encode_rows(pipe, pre.pending_rows(tsv, out_dir), batch_size=2)
    assert pre.pending_rows(tsv, out_dir) == []
    assert sorted(os.listdir(out_dir)) == [f"img{i}.jpg.npy"
                                           for i in range(5)]
    for i in range(1, 5):
        a = np.load(os.path.join(jdir, "clip_embs", f"img{i}.jpg.npy"))
        b = np.load(os.path.join(out_dir, f"img{i}.jpg.npy"))
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
        np.testing.assert_allclose(b.astype(np.float32),
                                   a.astype(np.float32), rtol=2 ** -10,
                                   atol=2 ** -14)
    # the fp32 embeddings themselves, rows 1-4 (row 0 was skipped)
    caps = [f"a photo of thing {i} on a table" for i in range(1, 5)]
    with torch.no_grad():
        got = pipe(prompt=caps, return_prompts_only=True).numpy()
    assert [w.shape[0] for w in want] == [2, 2]
    np.testing.assert_allclose(got, np.concatenate(want), atol=1e-5,
                               rtol=1e-5)


def test_sd_embeddings_cli_writes_77x768_fp16(tmp_path, capsys):
    """The port's CLI at SD v1.5's text widths (random tower, tiny
    tokenizer, as gill_tpu without weights)."""
    from gill_tpu_torch.scripts import preprocess_sd_embeddings as pre

    tsv = _tsv(tmp_path / "caps.tsv", 3)
    pre.main(["--tsv", tsv, "--image-dir", str(tmp_path), "--sd-dir",
              str(tmp_path / "none"), "--device", "cpu"])
    assert "random weights + tiny tokenizer" in capsys.readouterr().out
    for i in range(3):
        e = np.load(tmp_path / "clip_embs" / f"img{i}.jpg.npy")
        assert e.shape == (77, 768) and e.dtype == np.float16
        assert np.isfinite(e).all()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return apps.load_pair(apps.ckpt_dir(tmp_path_factory.mktemp("ckpt")))


def test_p2_images_match_gill_tpu(tmp_path, monkeypatch):
    """gill_tpu's P2 script (its loader, config and tokenizer patched to
    tiny SD weights made with the port's init) against the port's
    `generate_p2` on the same weights, both on shared latents, batches of
    2 over 4 prompts."""
    import gill_tpu.api
    import gill_tpu.models.sd.pipeline as jpipe_mod
    import gill_tpu.tokenizer as jtok
    from gill_tpu_torch.config import tiny_sd_config
    from gill_tpu_torch.models import clip as tclip
    from gill_tpu_torch.models.sd import unet as tunet
    from gill_tpu_torch.models.sd import vae as tvae
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.scripts import generate_sd_p2_images as p2
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer
    from gill_tpu_torch.weights.from_jax import tree_to_numpy

    cfg = tiny_sd_config()
    init = Init(torch.Generator().manual_seed(0), "cpu")
    params = {"unet": tunet.init(init, cfg.unet),
              "vae_decoder": tvae.init_decoder(init, cfg.vae),
              "text_encoder": tclip.init_text(init, cfg.text)}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(params))
    tp = StableDiffusionPipeline(cfg, params,
                                 tokenizer=CLIPBPETokenizer.tiny())
    jcfg = jpipe_mod.tiny_sd_config()
    jp = jpipe_mod.StableDiffusionPipeline(jcfg, jparams)
    with open(tmp_path / "p2.tsv", "w") as f:
        f.write("Prompt\tCategory\n")
        for i in range(4):
            f.write(f"a red cube number {i}\tcat\n")
    jrec, trec = apps.share_latents(jp, tp)
    monkeypatch.setattr(gill_tpu.api, "wloader_sd", lambda *a: jparams)
    monkeypatch.setattr(jpipe_mod, "SDPipelineConfig", lambda: jcfg)
    monkeypatch.setattr(jtok.CLIPBPETokenizer, "from_files",
                        classmethod(lambda cls, *a: cls.tiny()))
    monkeypatch.setattr(jpipe_mod, "StableDiffusionPipeline", type(jp))
    try:
        apps.run_jax(monkeypatch, "scripts/generate_sd_p2_images.py",
                 [str(tmp_path / "p2.tsv"), str(tmp_path / "j"),
                  "--batch-size", "2", "--num-inference-steps", "2"])
        paths = p2.generate_p2(tp, p2.read_prompts(str(tmp_path / "p2.tsv")),
                               str(tmp_path / "t"), batch_size=2,
                               num_inference_steps=2)
    finally:
        apps.unshare(tp)
    names = [f"{i}.png" for i in range(4)]
    assert [os.path.basename(p) for p in paths] == names
    assert sorted(os.listdir(tmp_path / "j")) == names
    assert [r[1].shape[0] for r in trec] == [2, 2]
    assert len(jrec) == len(trec)
    for (_, ji), (_, ti) in zip(jrec, trec):
        np.testing.assert_allclose(ti, ji, atol=1e-4)


# ---------------------------------------------------------------------------
# decision classifier
# ---------------------------------------------------------------------------

def _annotations(path, n):
    rng = np.random.RandomState(3)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["Prompt", "Category", "Decision"])
        for i in range(n):
            w.writerow([f"prompt {i} about a {['cat', 'car'][i % 2]}",
                        "c", ["gen", "ret", "same"][rng.randint(3)]])
    return str(path)


def test_decision_features_match_gill_tpu(pair, tmp_path):
    """The port's [IMG0] features against the JAX script's recipe (the
    retrieval-mode forward's llm_hidden[:, 0]) on the same prompts."""
    from gill_tpu_torch.scripts import train_decision_classifier as tdc

    jm, tm = pair
    prompts, labels = tdc.read_annotations(
        _annotations(tmp_path / "a.tsv", 20))
    assert set(labels.tolist()) <= {0, 1} and len(prompts) == len(labels)
    got = tdc.extract_features(tm, prompts)
    core, tok = jm.core, jm.tokenizer
    img_run = "".join(f"[IMG{i}]" for i in range(core.cfg.num_tokens))
    fwd = jax.jit(lambda p, t, l: core.forward(
        p, jnp.zeros((t.shape[0], core.vis_cfg.image_size,
                      core.vis_cfg.image_size, 3)), t, l,
        mode="retrieval")["llm_hidden"])
    want = []
    for i in range(0, len(prompts), 16):
        enc = tok([c + img_run for c in prompts[i:i + 16]],
                  padding="max_length", truncation=True, max_length=64,
                  return_tensors="np")
        lens = enc.attention_mask.sum(axis=1).astype(np.int32)
        want.append(np.asarray(fwd(jm.params, jnp.asarray(enc.input_ids),
                                   jnp.asarray(lens))[:, 0, :], np.float32))
    want = np.concatenate(want)
    assert got.shape == want.shape == (len(prompts), 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_macro_f1_and_adamw_step_match_gill_tpu():
    import optax

    from gill_tpu.models import decision as jdec
    from gill_tpu_torch.scripts import train_decision_classifier as tdc

    jtdc = apps.jax_script("scripts/train_decision_classifier.py")
    rng = np.random.RandomState(7)
    for n in (1, 5, 40):
        preds, labels = rng.randint(0, 2, n), rng.randint(0, 2, n)
        assert tdc.macro_f1(preds, labels) == jtdc.macro_f1(preds, labels)
    x = rng.randn(12, 32).astype(np.float32)
    y = rng.randint(0, 2, 12).astype(np.int32)
    dp = jdec.init(jax.random.PRNGKey(0), in_dim=32)
    tx = optax.adamw(1e-3)
    grads = jax.grad(lambda d: optax.softmax_cross_entropy_with_integer_labels(
        jdec.apply(d, jnp.asarray(x)), jnp.asarray(y)).mean())(dp)
    updates, _ = tx.update(grads, tx.init(dp), dp)
    want = optax.apply_updates(dp, updates)
    params = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True)
              for k, v in dp.items()}
    tdc.train_step(params, tdc.make_optimizer(params, 1e-3),
                   torch.from_numpy(x), torch.from_numpy(y))
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-6, rtol=0)


def test_decision_cli_trains_and_routes(pair, tmp_path, monkeypatch):
    """The port's CLI end to end: features, 200 steps, the best macro-F1's
    weights saved; they load through utils/ckpt.py and route a request."""
    from gill_tpu_torch.models import decision as decision_mod
    from gill_tpu_torch.scripts import train_decision_classifier as tdc
    from gill_tpu_torch.utils.ckpt import load_decision_model

    _, tm = pair
    monkeypatch.setattr(tdc, "load_model", lambda *a, **k: tm)
    out = str(tmp_path / "decision_model.npz")
    best, f1 = tdc.main(["--annotations", _annotations(tmp_path / "a.tsv", 30),
                         "--out", out, "--steps", "200", "--device", "cpu"])
    assert 0.0 <= f1 <= 1.0
    dp = load_decision_model(out)
    assert dp["w"].shape == (16, 2) and dp["b"].shape == (2,)
    np.testing.assert_array_equal(dp["w"], best["w"])
    label, probs = decision_mod.decide(
        {k: torch.from_numpy(v) for k, v in dp.items()}, torch.ones(1, 16))
    assert label in ("gen", "ret") and len(probs[0]) == 2


# ---------------------------------------------------------------------------
# validate_real_weights
# ---------------------------------------------------------------------------

@pytest.fixture()
def no_env_assets(monkeypatch):
    for k in ("GILL_TPU_WEIGHTS_DIR", "GILL_TPU_TOKENIZER_DIR",
              "GILL_TPU_LPIPS_WEIGHTS"):
        monkeypatch.delenv(k, raising=False)


def test_validate_skips_like_gill_tpu(tmp_path, no_env_assets):
    from gill_tpu_torch.scripts import validate_real_weights as vrw

    jvrw = apps.jax_script("scripts/validate_real_weights.py")
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    reports = []
    for mod, extra in ((jvrw, []), (vrw, ["--device", "cpu"])):
        out = str(tmp_path / f"{len(reports)}.json")
        assert mod.run(mod.parse_args(["--weights-dir", empty,
                                       "--tokenizer-dir", empty, "--out",
                                       out] + extra)) == 0
        reports.append(json.load(open(out)))
    want, got = reports
    assert list(got["results"]) == list(want["results"]) == list(vrw.CHECKS)
    for name, res in got["results"].items():
        assert res["status"] == want["results"][name]["status"] == "SKIPPED"
        assert res["reason"]
    assert got["summary"] == want["summary"]
    with pytest.raises(ValueError):
        vrw.run(vrw.parse_args(["--only", "nope", "--out",
                                str(tmp_path / "x.json")]))


def _hf_opt(transformers, d, seed):
    from gill_tpu_torch.config import OPTConfig

    cfg = OPTConfig.from_name("test/opt-tiny")
    torch.manual_seed(seed)
    transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        ffn_dim=cfg.ffn_dim, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        word_embed_proj_dim=cfg.word_embed_proj_dim,
        max_position_embeddings=cfg.max_positions,
        do_layer_norm_before=cfg.do_layer_norm_before, dropout=0.0,
        attention_dropout=0.0, activation_function="relu")
    ).eval().save_pretrained(d)


def test_validate_checks_pass_on_synthetic_assets(tmp_path, no_env_assets):
    """tests/test_validate_real_weights.py's synthetic assets: HF OPT and
    CLIP directories, a diffusers-layout tiny SD (written from the port's
    init through chip_smoke's key maps), an LPIPS npz, the tokenizer
    fixture, a byte vocabulary and captions for specdec."""
    transformers = pytest.importorskip("transformers")
    import chip_smoke
    from gill_tpu.tokenizer import bytes_to_unicode
    from gill_tpu_torch.config import (CLIPVisionConfig, tiny_unet_config,
                                       tiny_vae_config)
    from gill_tpu_torch.models.sd import unet as tunet
    from gill_tpu_torch.models.sd import vae as tvae
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.scripts import validate_real_weights as vrw
    from test_torch_evals import _lpips_npz

    w = tmp_path / "w"
    _hf_opt(transformers, str(w / "opt-tiny"), seed=0)
    cfg = CLIPVisionConfig.from_name("test/clip-tiny")
    torch.manual_seed(1)
    transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        projection_dim=8)).eval().save_pretrained(str(w / "clip-tiny"))
    # a diffusers-layout tiny SD through chip_smoke's inverse key maps
    init = Init(torch.Generator().manual_seed(2), "cpu")
    sd = tmp_path / "sd"
    for sub, state in (
            ("unet", chip_smoke.unet_to_diffusers(
                tunet.init(init, tiny_unet_config()))),
            ("vae", chip_smoke.vae_to_diffusers(
                tvae.init_decoder(init, tiny_vae_config())))):
        os.makedirs(sd / sub)
        torch.save({k: v.detach().clone() for k, v in state.items()},
                   str(sd / sub / "pytorch_model.bin"))
    tok = tmp_path / "tok"
    os.makedirs(tok)
    with open(tok / "vocab.json", "w") as f:
        json.dump({ch: i for i, ch in enumerate(bytes_to_unicode().values())},
                  f)
    with open(tok / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    caps = tmp_path / "caps.tsv"
    with open(caps, "w") as f:
        f.write("caption\timage\n")
        for i in range(3):
            f.write(f"a tiny caption number {i}\timg{i}.jpg\n")
    out = str(tmp_path / "report.json")
    argv = ["--device", "cpu", "--out", out]
    runs = {
        "opt": ["--opt-name", "test/opt-tiny", "--weights-dir", str(w)],
        "clip": ["--clip-name", "test/clip-tiny", "--weights-dir", str(w)],
        "sd": ["--sd-dir", str(sd), "--sd-config", "tiny"],
        "lpips": ["--lpips-weights", _lpips_npz(str(tmp_path / "l.npz"))],
        "tokenizer": ["--tokenizer-dir", os.path.join(HERE, "fixtures",
                                                      "tok")],
        "specdec": ["--opt-name", "test/opt-tiny", "--draft-name",
                    "test/opt-tiny", "--weights-dir", str(w),
                    "--tokenizer-dir", str(tok), "--cc3m-tsv", str(caps),
                    "--n-captions", "2", "--spec-k", "4"]}
    for name, extra in runs.items():
        assert vrw.main(["--only", name] + extra + argv) == 0, name
        res = json.load(open(out))["results"][name]
        assert res["status"] == "PASS", (name, res)
    assert res["acceptance_rate"] == pytest.approx(1.0)   # self-drafting


@pytest.mark.parametrize("module,argv", [
    ("scripts.extract_img_embs", ["a.png"]),
    ("scripts.train_decision_classifier", []),
    ("evals.generate_vist_images", ["out"]),
    ("examples.inference_examples", []),
])
def test_entry_points_default_to_the_card(module, argv, monkeypatch):
    """Without --device an entry point asks for the card, and without one
    it raises before it loads anything."""
    import importlib

    mod = importlib.import_module(f"gill_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "load_model", lambda *a, **k: pytest.fail(
        "loaded a model without a device"))
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        mod.main(argv)
