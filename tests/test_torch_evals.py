"""The port's eval entry points (gill_tpu_torch/evals/ and
scripts/extract_img_embs.py) against gill_tpu's own scripts on the same
inputs, on the CPU.

gill_tpu's scripts are imported by path and run through their `main()`
with `sys.argv` set, their `load_gill` patched to hand over the tiny
model that tests/torch_app_models.py loads once (the port's modules get
the same model, parameters carried over, through their `load_model`).
Tolerances:
  * LPIPS distances (256² AlexNet, seeded random weights in gill_tpu's
    .npz layout): 1e-5 absolute;
  * CLIP-similarity scores: 1e-5;
  * extracted retrieval embeddings: 1e-5;
  * VIST / VisDial generation, sequential and --batch: the text (greedy
    tokens up to and including the [IMG] run) equal, an image for each
    prompt, and each SD call's generation embeddings within 1e-4
    relative and its images within 1e-4 on [0, 1] pixels, both sides
    denoising the same latents (tests/test_torch_gill_e2e.py's rule).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import torch_app_models as apps

STEPS = 2


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return apps.load_pair(apps.ckpt_dir(tmp_path_factory.mktemp("ckpt")))


def _images(d, n, seed, size=20):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (size, size + 4, 3), np.uint8)
                        ).save(os.path.join(d, f"im{i}.png"))


@pytest.fixture(scope="module")
def vist_dir(tmp_path_factory):
    """2 stories x 3 steps of seeded random images and captions."""
    root = tmp_path_factory.mktemp("vist")
    _images(str(root / "val_images"), 6, seed=0)
    stories = {f"story{s}": [
        {"caption": f"step {i} of story {s}, a dog runs", "image_id":
         f"im{3 * s + i}", "sequence_index": i} for i in range(3)]
        for s in range(2)}
    with open(root / "val_formatted.json", "w") as f:
        json.dump({"annotations": stories}, f)
    return str(root)


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def _lpips_npz(path):
    rng = np.random.RandomState(5)
    chans = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
             (256, 256, 3)]
    blobs = {}
    for i, (cin, cout, k) in enumerate(chans):
        blobs[f"conv{i}_w"] = (rng.randn(k, k, cin, cout) * 0.05
                               ).astype(np.float32)
        blobs[f"conv{i}_b"] = (rng.randn(cout) * 0.01).astype(np.float32)
        blobs[f"lin{i}_w"] = rng.rand(cout).astype(np.float32)
    np.savez(path, **blobs)
    return path


def _scores(path):
    lines = open(path).read().splitlines()
    per = {ln.split(": ")[0]: float(ln.split(": ")[1]) for ln in lines[:-1]}
    return per, float(lines[-1].split(": ")[1])


def test_lpips_matches_gill_tpu(tmp_path, monkeypatch):
    from gill_tpu_torch.evals import lpips_2dirs

    w = _lpips_npz(str(tmp_path / "lpips.npz"))
    d0, d1 = str(tmp_path / "a"), str(tmp_path / "b")
    _images(d0, 3, seed=1, size=40)
    _images(d1, 2, seed=2, size=40)          # im2 has no pair
    apps.run_jax(monkeypatch, "evals/lpips_2dirs.py",
             ["-d0", d0, "-d1", d1, "-o", str(tmp_path / "j.txt"),
              "--lpips-weights", w])
    lpips_2dirs.main(["-d0", d0, "-d1", d1, "-o", str(tmp_path / "t.txt"),
                      "--lpips-weights", w, "--device", "cpu"])
    want, want_avg = _scores(str(tmp_path / "j.txt"))
    got, got_avg = _scores(str(tmp_path / "t.txt"))
    assert sorted(got) == sorted(want) == ["im0.png", "im1.png"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
        assert got[k] > 1e-3
    assert abs(got_avg - want_avg) <= 1e-5
    # d(x, x) = 0 on the port
    params = lpips_2dirs.load_lpips_weights(w, "cpu")
    x = lpips_2dirs.load_image(os.path.join(d0, "im0.png"), "cpu")
    assert float(lpips_2dirs.lpips_distance(params, x, x)) < 1e-6


def test_lpips_exits_2_without_weights(tmp_path):
    from gill_tpu_torch.evals import lpips_2dirs

    with pytest.raises(SystemExit) as e:
        lpips_2dirs.main(["-d0", str(tmp_path), "-d1", str(tmp_path),
                          "--lpips-weights", "", "--device", "cpu"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# generation: VIST, VisDial
# ---------------------------------------------------------------------------

def _record_texts(model, texts):
    """Wraps the model's two generation calls to keep each output's text."""
    seq, bat = model.generate_for_images_and_texts, \
        model.generate_for_images_and_texts_batch

    def one(*a, **k):
        outs = seq(*a, **k)
        texts.append(outs[0])
        return outs

    def many(*a, **k):
        all_outs = bat(*a, **k)
        texts.extend(o[0] for o in all_outs)
        return all_outs

    model.generate_for_images_and_texts = one
    model.generate_for_images_and_texts_batch = many


def _generate_both(pair, monkeypatch, tmp_path, jax_rel, port_mod, argv,
                   tag):
    jm, tm = pair
    jrec, trec = apps.share_latents(jm.sd_pipe, tm.sd_pipe)
    jtexts = []
    _record_texts(jm, jtexts)
    try:
        jout, tout = str(tmp_path / f"j_{tag}"), str(tmp_path / f"t_{tag}")
        apps.run_jax(monkeypatch, jax_rel, [jout] + argv, model=jm)
        monkeypatch.setattr(port_mod, "load_model", lambda *a, **k: tm)
        got = port_mod.main([tout] + argv + ["--device", "cpu"])
    finally:
        apps.unshare(jm.sd_pipe, tm.sd_pipe)
        for name in ("generate_for_images_and_texts",
                     "generate_for_images_and_texts_batch"):
            jm.__dict__.pop(name, None)
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    assert list(got.values()) == jtexts
    assert all("[IMG0]" in t for t in jtexts)
    apps.assert_records_close(jrec, trec)
    for fn in os.listdir(jout):
        a = np.asarray(Image.open(os.path.join(jout, fn)), np.int32)
        b = np.asarray(Image.open(os.path.join(tout, fn)), np.int32)
        assert a.shape == b.shape == (16, 16, 3) and np.abs(a - b).max() <= 1
    return got


def test_vist_generation_matches_gill_tpu(pair, vist_dir, tmp_path,
                                          monkeypatch):
    from gill_tpu_torch.evals import generate_vist_images as gv

    argv = ["--model-dir", "unused", "--vist-dir", vist_dir,
            "--num-inference-steps", str(STEPS)]
    seq = _generate_both(pair, monkeypatch, tmp_path,
                         "evals/generate_vist_images.py", gv, argv, "seq")
    assert sorted(seq) == ["im2", "im5"]
    bat = _generate_both(pair, monkeypatch, tmp_path,
                         "evals/generate_vist_images.py", gv,
                         argv + ["--batch", "2"], "bat")
    assert bat == seq           # greedy tokens: the batch route's are equal


@pytest.fixture()
def visdial_dir(tmp_path):
    qs = ["is it sunny", "how many dogs", "what color is the car"]
    ans = ["yes", "two", "red"]
    dialogs = [{"image_id": 42 + d, "dialog": [
        {"question": (d + i) % 3, "answer": (d + 2 * i) % 3}
        for i in range(2 + d)]} for d in range(2)]
    with open(tmp_path / "visdial_1.0_val.json", "w") as f:
        json.dump({"data": {"questions": qs, "answers": ans,
                            "dialogs": dialogs}}, f)
    with open(tmp_path / "visdial_1.0_val_dense_annotations.json",
              "w") as f:
        json.dump([{}, {}], f)
    return str(tmp_path)


def test_visdial_generation_matches_gill_tpu(pair, visdial_dir, tmp_path,
                                             monkeypatch):
    from gill_tpu_torch.evals import generate_visdial_images as gd

    got = _generate_both(pair, monkeypatch, tmp_path,
                         "evals/generate_visdial_images.py", gd,
                         ["--model-dir", "unused", "--visdial-dir",
                          visdial_dir, "--num-inference-steps", str(STEPS),
                          "--batch", "2"], "visdial")
    assert sorted(got) == ["000000000042", "000000000043"]


# ---------------------------------------------------------------------------
# CLIP similarity, retrieval embeddings
# ---------------------------------------------------------------------------

def test_clip_similarity_matches_gill_tpu(vist_dir, tmp_path, monkeypatch):
    """Both scorers on random CLIP (the port's handed gill_tpu's
    PRNGKey(0) tower and identity projection) over VIST pairs."""
    import jax
    import jax.numpy as jnp

    from gill_tpu.config import CLIPVisionConfig as JCfg
    from gill_tpu.models import clip as jclip
    from gill_tpu_torch.config import CLIPVisionConfig
    from gill_tpu_torch.evals import compute_clip_similarity as ccs
    from gill_tpu_torch.weights.from_jax import clip_vision_from_jax

    gen = str(tmp_path / "gen")
    _images(gen, 6, seed=3)
    data = os.path.join(vist_dir, "val_formatted.json")
    gt = os.path.join(vist_dir, "val_images")
    argv = ["--dataset", "vist", "--gen-dir", gen, "--gt-dir", gt,
            "--data-path", data, "--clip-model", "test/clip-tiny"]
    apps.run_jax(monkeypatch, "evals/compute_clip_similarity.py",
             argv + ["--out", str(tmp_path / "j.txt")])
    jcfg = JCfg.from_name("test/clip-tiny")
    jp = jclip.init_vision(jax.random.PRNGKey(0), jcfg)
    jp["visual_projection"] = {"w": jnp.eye(jcfg.hidden_size, 768)}
    cfg = CLIPVisionConfig.from_name("test/clip-tiny")
    monkeypatch.setattr(ccs, "load_clip", lambda *a: (
        clip_vision_from_jax(jax.device_get(jp)), cfg))
    score = ccs.main(argv + ["--out", str(tmp_path / "t.txt"),
                             "--device", "cpu"])
    want = float(open(tmp_path / "j.txt").read())
    assert float(open(tmp_path / "t.txt").read()) == score
    assert -1.0 <= score <= 1.0 and abs(score - want) <= 1e-5
    # an image against itself
    px = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    params, _ = ccs.load_clip("test/clip-tiny", None, torch.device("cpu"))
    same = ccs.cos_sim(params, cfg, px, px)
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-5)


def test_random_clip_warns_and_projects(capsys):
    from gill_tpu_torch.evals import compute_clip_similarity as ccs

    params, cfg = ccs.load_clip("test/clip-tiny", None, torch.device("cpu"))
    assert "WARNING: CLIP weights unavailable" in capsys.readouterr().out
    assert torch.equal(params["visual_projection"]["w"],
                       torch.eye(cfg.hidden_size, 768))


def test_extract_img_embs_matches_gill_tpu(pair, vist_dir, tmp_path,
                                           monkeypatch):
    from gill_tpu_torch.retrieval import load_embeddings
    from gill_tpu_torch.scripts import extract_img_embs as ex

    jm, tm = pair
    imgs = [os.path.join(vist_dir, "val_images", f"im{i}.png")
            for i in range(5)]
    apps.run_jax(monkeypatch, "scripts/extract_img_embs.py",
             imgs + ["--out", str(tmp_path / "cc3m_j.npy"),
                     "--batch-size", "2"], model=jm)
    monkeypatch.setattr(ex, "load_model", lambda *a, **k: tm)
    ex.main(imgs + ["--out", str(tmp_path / "cc3m_t.npy"), "--batch-size",
                    "2", "--device", "cpu"])
    with open(tmp_path / "cc3m_j.npy", "rb") as f:
        want = pickle.load(f)
    paths, got = load_embeddings(str(tmp_path), "cc3m_t.npy")
    assert paths == want["paths"] == imgs
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got, np.stack(want["embeddings"]), atol=1e-5,
                               rtol=1e-5)
