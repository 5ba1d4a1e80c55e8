"""The port's last tools against gill_tpu's, on the CPU: the tokenizer
fixture script, the LPIPS weight converter, the VIST formatter, the
kv-window probe's tiny phase and the collective recorder.

  * `scripts.make_tokenizer_fixture` writes tests/fixtures/tok's
    vocab.json and merges.txt byte for byte;
  * `scripts.convert_lpips_weights` on seeded fake `alex.pth` / AlexNet
    state dicts: the arrays in gill_tpu's .npz layout, and the port's
    LPIPS and gill_tpu's (evals/lpips_2dirs.py) on that .npz within 1e-5
    of each other (evals' tolerance);
  * `evals.download_vist_images` on a synthetic annotation file, the fetch
    replaced in both: the formatted JSON and the saved images equal to
    evals/download_vist_images.py's;
  * `scripts.profile_kv_window.run_engine` at a 2-layer OPT in fp32: the
    tokens with the read ladder on equal those with it off, and gill_tpu's
    `DecodeEngine(kv_read_buckets="auto")` on the same parameters and trace;
  * `parallel.collectives.record_collectives` at tp 1 in one process:
    nothing issued, the step's logits and tokens the same with it open
    (the tp-2 and tp-4 launches of tests/test_torch_dist_tp.py count the
    all-reduces a step issues).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_app_models as apps
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def test_make_tokenizer_fixture_regenerates_the_fixture(tmp_path, capsys):
    from gill_tpu_torch.scripts import make_tokenizer_fixture

    assert make_tokenizer_fixture.main([str(tmp_path)]) == 0
    assert "568 vocab entries, 311 merges" in capsys.readouterr().out
    for name in ("vocab.json", "merges.txt"):
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(ROOT, "tests", "fixtures", "tok", name),
                     "rb") as b:
            assert a.read() == b.read(), name


ALEX = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
        (256, 256, 3)]


def _fake_state_dicts(style: str):
    """Seeded stand-ins for torchvision's AlexNet (or an LPIPS module's
    `net.slice*` copy of it) and lpips' v0.1 `alex.pth`."""
    rng = np.random.RandomState(9)
    alex, lin = {}, {}
    for i, (ci, (cin, cout, k)) in enumerate(zip((0, 3, 6, 8, 10), ALEX)):
        w = torch.from_numpy((rng.randn(cout, cin, k, k) * 0.05)
                             .astype(np.float32))
        b = torch.from_numpy((rng.randn(cout) * 0.01).astype(np.float32))
        key = (f"features.{ci}" if style == "torchvision"
               else f"net.slice{min(i, 4) + 1}.{ci}")
        alex[f"{key}.weight"], alex[f"{key}.bias"] = w, b
        lin[f"lin{i}.model.1.weight"] = torch.from_numpy(
            rng.rand(1, cout, 1, 1).astype(np.float32))
    alex["classifier.1.weight"] = torch.zeros(4, 4)
    return lin, alex


@pytest.mark.parametrize("style", ["torchvision", "lpips_module"])
def test_lpips_converter_gives_gill_tpus_distance(tmp_path, style):
    from gill_tpu_torch.evals import lpips_2dirs
    from gill_tpu_torch.scripts import convert_lpips_weights

    lin, alex = _fake_state_dicts(style)
    torch.save(lin, tmp_path / "alex.pth")
    torch.save(alex, tmp_path / "alexnet.pth")
    out = str(tmp_path / "lpips.npz")
    assert convert_lpips_weights.main(["--lpips", str(tmp_path / "alex.pth"),
                                       "--alexnet",
                                       str(tmp_path / "alexnet.pth"),
                                       out]) == 0
    with np.load(out) as z:
        assert sorted(z.files) == sorted(
            [f"conv{i}_{p}" for i in range(5) for p in "wb"]
            + [f"lin{i}_w" for i in range(5)])
        w0 = next(v for k, v in alex.items() if k.endswith(".0.weight"))
        np.testing.assert_array_equal(z["conv0_w"],
                                      w0.numpy().transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(z["lin4_w"],
                                      lin["lin4.model.1.weight"].reshape(-1))
    rng = np.random.RandomState(2)
    x0, x1 = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
              for _ in range(2))
    params = lpips_2dirs.load_lpips_weights(out, "cpu")
    got = float(lpips_2dirs.lpips_distance(params, torch.from_numpy(x0),
                                           torch.from_numpy(x1)))
    jl = apps.jax_script("evals/lpips_2dirs.py")
    want = float(jl.lpips_distance(jl.load_lpips_weights(out), x0, x1))
    assert got > 1e-3 and abs(got - want) <= 1e-5, (got, want)


def _vist_json(path):
    rng = np.random.RandomState(6)
    anns, images = [], []
    for s in range(3):
        for i in range(4):
            iid = f"{1000 + 10 * s + i}"
            anns.append([{"story_id": f"{40 + s}", "text": f"story {s} step "
                          f"{i}: a {rng.choice(['dog', 'cat', 'tree'])}",
                          "photo_flickr_id": iid,
                          "worker_arranged_photo_order": i}])
            images.append({"id": iid, **({} if iid.endswith("3") else {
                "url_o": f"https://example.invalid/{iid}.jpg"})})
    anns.append([{"story_id": "40", "text": "a repeated photo",
                  "photo_flickr_id": "1000",
                  "worker_arranged_photo_order": 4}])
    images.append({"id": "9999", "url_o": "https://example.invalid/x.jpg"})
    with open(path, "w") as f:
        json.dump({"annotations": anns, "images": images}, f)


def _fake_fetch(url):
    from PIL import Image

    if url.endswith("1021.jpg"):
        raise OSError("404")
    v = sum(map(ord, url)) % 256
    return Image.new("RGB", (224, 224), (v, 255 - v, 7))


def test_vist_formatter_equals_gill_tpus(tmp_path, monkeypatch):
    from gill_tpu_torch.evals import download_vist_images
    from gill_tpu_torch.utils import image as image_utils

    src = str(tmp_path / "val.json")
    _vist_json(src)
    mod = apps.jax_script("evals/download_vist_images.py")
    monkeypatch.setattr(mod, "get_image_from_url", _fake_fetch)
    monkeypatch.setattr(sys, "argv", [
        "download_vist_images.py", "--vist-json", src, "--out-images",
        str(tmp_path / "j_img"), "--out-formatted", str(tmp_path / "j.json")])
    mod.main()
    monkeypatch.setattr(image_utils, "get_image_from_url", _fake_fetch)
    assert download_vist_images.main([
        "--vist-json", src, "--out-images", str(tmp_path / "t_img"),
        "--out-formatted", str(tmp_path / "t.json")]) == 0
    with open(tmp_path / "j.json", "rb") as a, \
            open(tmp_path / "t.json", "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(tmp_path / "j_img"))
    assert names == sorted(os.listdir(tmp_path / "t_img"))
    assert len(names) == 8      # 12 photos, 3 without url_o, 1 fetch fails
    for n in names:
        with open(tmp_path / "j_img" / n, "rb") as a, \
                open(tmp_path / "t_img" / n, "rb") as b:
            assert a.read() == b.read(), n


def test_kv_window_tiny_phase_equals_gill_tpu():
    import jax.numpy as jnp

    from gill_tpu.config import OPTConfig as JCfg
    from gill_tpu.serve.engine import DecodeEngine as JEngine
    from gill_tpu.serve.engine import ServeRequest as JRequest
    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.scripts import profile_kv_window as kvw
    from gill_tpu_torch.serve.engine import ServeRequest
    from gill_tpu_torch.weights import from_jax

    opt = dict(vocab_size=128, hidden_size=32, ffn_dim=64, num_layers=2,
               num_heads=4, word_embed_proj_dim=32, max_positions=600)
    cfg = OPTConfig(**opt)
    params = kvw.tiny_params(cfg, "cpu")
    # one prompt long enough that its window leaves the 256-row rung
    lens, gens = (250, 20, 61, 100, 9), (14, 9, 12, 5, 11)
    rng = np.random.RandomState(3)
    trace = [(u, rng.randint(2, 120, size=n).tolist(), g)
             for u, (n, g) in enumerate(zip(lens, gens))]
    reqs = [ServeRequest(uid=u, prompt=p, max_new_tokens=g)
            for u, p, g in trace]
    kw = dict(max_seq=512, slots=4, chunk=8, prefill_buckets=(64, 128, 256),
              device="cpu", warmup=False, warm_requests=False)
    on = kvw.run_engine(params, cfg, reqs, ladder=True, **kw)
    off = kvw.run_engine(params, cfg, reqs, ladder=False, **kw)
    assert on["kv_ladder"] == [256, 512] and off["kv_ladder"] == [512]
    assert 0.5 < on["mean_window_frac"] < 1.0 == off["mean_window_frac"]
    assert on["tokens"] == off["tokens"]
    assert on["generated"] == on["budget"] == sum(gens)
    je = JEngine(from_jax.tree_to_numpy(params), JCfg(**opt), slots=4,
                 max_seq=512, chunk=8, prefill_buckets=(64, 128, 256),
                 unroll_layers=False, kv_dtype=jnp.float32,
                 kv_read_buckets="auto")
    want = je.run_pipelined([JRequest(uid=u, prompt=p, max_new_tokens=g)
                             for u, p, g in trace])
    assert on["tokens"] == want


def test_collective_recorder_at_tp1_issues_nothing():
    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.parallel import collectives
    from gill_tpu_torch.parallel.mesh import create_mesh
    from gill_tpu_torch.scripts import tp_collective_budget as tcb

    cfg = OPTConfig(vocab_size=64, hidden_size=32, ffn_dim=64, num_layers=2,
                    num_heads=8, word_embed_proj_dim=32, max_positions=96)
    params, cfg = tcb.host_tree(cfg, torch.device("cpu"), torch.float32)
    rep = tcb.measure(params, cfg, create_mesh(1, 1), torch.device("cpu"),
                      batch=3, max_seq=32, reps=1)
    assert rep["tp"] == 1 and rep["rows"] == [] and rep["collectives"] == 0
    assert rep["backend"] is None and rep["collective_ms_a_step"] is None
    assert rep["tokens_equal_with_recorder"]
    assert rep["logits_equal_with_recorder"]
    assert collectives._RECORDER is None
    with collectives.record_collectives() as outer:
        with collectives.record_collectives() as inner:
            assert collectives._RECORDER is inner
        assert collectives._RECORDER is outer
    assert collectives._RECORDER is None
