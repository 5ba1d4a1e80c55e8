"""The port's demo (gill_tpu_torch/demo/app_gradio.py) and inference
examples (gill_tpu_torch/examples/inference_examples.py) against gill_tpu's
own demo/app_gradio.py and examples/inference_examples.py on the same
tiny model (tests/torch_app_models.py), on the CPU.

gill_tpu's scripts are imported by path. The web branch of both demos is
driven through tests/test_demo_gradio.py's fake-gradio shim, the REPL on
scripted input. Held equal: every reply's text and the route of each
output (text, retrieved or generated image); the examples' printed text
and decisions and the saved files' names; the log-likelihood within 1e-5
relative. Where an image is generated both sides denoise the same
latents (2 denoising steps where the scripts ask for 50): each SD call's
embeddings within 1e-4 relative, its images within 1e-4 on [0, 1] pixels.
"""

import builtins
import os
import sys
import types
import unittest.mock as mock

import numpy as np
import pytest
from PIL import Image

import torch_app_models as apps
from test_demo_gradio import _FakeGradio


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return apps.load_pair(apps.ckpt_dir(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture()
def shared(pair):
    """Both SD pipelines on shared latents, 2 denoising steps, for one
    test; the records."""
    jm, tm = pair
    yield apps.share_latents(jm.sd_pipe, tm.sd_pipe, steps=2)
    apps.unshare(jm.sd_pipe, tm.sd_pipe)


def _picture(path):
    Image.fromarray(np.random.RandomState(4).randint(
        0, 256, (30, 26, 3), np.uint8)).save(path)
    return path


# ---------------------------------------------------------------------------
# inference examples
# ---------------------------------------------------------------------------

def test_inference_examples_match_gill_tpu(pair, shared, tmp_path,
                                           monkeypatch, capsys):
    from gill_tpu_torch.examples import inference_examples as ex

    jm, tm = pair
    img = _picture(str(tmp_path / "ctx.png"))
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    apps.run_jax(monkeypatch, "examples/inference_examples.py",
                 ["--image", img, "--out-dir", jout], model=jm)
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(ex, "load_model", lambda *a, **k: tm)
    res = ex.main(["--image", img, "--out-dir", tout, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()

    def ll(lines):
        return [float(ln.rsplit(" ", 1)[1]) for ln in lines
                if ln.startswith("log-likelihood")]

    def shown(lines):
        return [ln for ln in lines if ln.startswith(("---", "text:",
                                                     "decision:"))]

    assert shown(got) == shown(want)
    assert [t for t in shown(got) if t.startswith("---")] == [
        "--- caption ---", "--- forced_image ---", "--- dialogue ---"]
    assert ll(got)[0] == pytest.approx(ll(want)[0], rel=1e-5)
    assert res["log_likelihood"] == ll(got)[0]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    assert "forced_image_gen0.png" in os.listdir(tout)
    assert isinstance(res["forced_image"][1], dict)
    apps.assert_records_close(*shared)


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

def _demo_args(tmp_path, name):
    args = types.SimpleNamespace(host="0.0.0.0", port=7860,
                                 save_dir=str(tmp_path / name))
    os.makedirs(args.save_dir, exist_ok=True)
    return args


def _texts(history):
    return [(msg, [r if isinstance(r, str) else r[1] for r in reply])
            for msg, reply in history]


def test_gradio_blocks_match_gill_tpu(pair, tmp_path):
    """Both demos' Blocks through the fake gradio: two turns (the first
    with an upload) and the export click, then `launch_gradio`."""
    from gill_tpu_torch.demo import app_gradio

    jm, tm = pair
    jdemo = apps.jax_script("demo/app_gradio.py")
    upload = np.random.RandomState(2).randint(0, 256, (24, 24, 3), np.uint8)
    histories = []
    for mod, model, name in ((jdemo, jm, "j"), (app_gradio, tm, "t")):
        fake = _FakeGradio()
        args = _demo_args(tmp_path, name)
        blocks = mod.build_blocks(fake, model, args)
        events = {kind: fn for kind, _, fn, _, _ in blocks.events}
        assert {type(c).__name__ for c in blocks.components} >= {
            "Chatbot", "Textbox", "Image", "Slider", "State", "Button",
            "File"}
        history, session = events["submit"]("hi there", upload, None, 1.3,
                                            0.0, None)
        assert session.conversation[0].size == (224, 224)
        history, session = events["submit"]("and again", None, history, 1.3,
                                            0.0, session)
        histories.append(_texts(history))
        path = events["click"](session)
        html = open(path).read()
        assert "hi there" in html and "data:image/png;base64," in html
        assert events["click"](None) is None
        with mock.patch.dict(sys.modules, {"gradio": fake}):
            mod.launch_gradio(model, args)
    assert histories[0] == histories[1]
    assert len(histories[1]) == 2


def test_chat_session_image_turn_matches_gill_tpu(pair, shared, tmp_path):
    """A text turn, then a turn forced to an image (gen_scale_factor
    1e6): replies equal, the second an image on both sides."""
    from gill_tpu_torch.demo import app_gradio

    jm, tm = pair
    jdemo = apps.jax_script("demo/app_gradio.py")
    replies = []
    for mod, model in ((jdemo, jm), (app_gradio, tm)):
        session = mod.ChatSession(model)
        first = session.user_turn("what is in the picture")
        session.gen_scale_factor = 1e6
        second = session.user_turn("show me a red car")
        assert any(isinstance(r, Image.Image) for r in second)
        replies.append([[r if isinstance(r, str) else r.size for r in x]
                        for x in (first, second)])
        path = mod.export_conversation_html(
            session.conversation, str(tmp_path / f"{len(replies)}.html"))
        assert open(path).read().count("data:image/png;base64,") == 1
    assert replies[0] == replies[1]
    apps.assert_records_close(*shared)


def test_repl_matches_gill_tpu(pair, tmp_path, monkeypatch, capsys):
    """The terminal REPL on scripted input: an image, two turns, /save."""
    from gill_tpu_torch.demo import app_gradio

    jm, tm = pair
    jdemo = apps.jax_script("demo/app_gradio.py")
    img = _picture(str(tmp_path / "ctx.png"))
    outs = []
    for mod, model, name in ((jdemo, jm, "j"), (app_gradio, tm, "t")):
        lines = iter([f"/img {img}", "", "describe it", "tell me more",
                      "/save", "/quit"])
        monkeypatch.setattr(builtins, "input", lambda *_: next(lines))
        args = _demo_args(tmp_path, name)
        mod.launch_repl(model, args)
        out = capsys.readouterr().out.splitlines()
        outs.append([ln.replace(args.save_dir, "<dir>") for ln in out
                     if ln.startswith("gill>")])
        assert "(image added to context)" in out
        saved = [f for f in os.listdir(args.save_dir) if f.endswith(".html")]
        assert len(saved) == 1
    assert outs[0] == outs[1] and len(outs[1]) >= 2


def test_main_falls_back_to_the_repl_without_gradio(pair, tmp_path,
                                                    monkeypatch, capsys):
    from gill_tpu_torch.demo import app_gradio

    _, tm = pair
    monkeypatch.setattr(app_gradio, "load_model", lambda *a, **k: tm)
    monkeypatch.setattr(builtins, "input", lambda *_: "/quit")
    with mock.patch.dict(sys.modules, {"gradio": None}):
        app_gradio.main(["--save-dir", str(tmp_path / "s"), "--device",
                         "cpu"])
    assert "starting terminal REPL" in capsys.readouterr().out
    fake = _FakeGradio()
    launched = []
    monkeypatch.setattr(app_gradio, "launch_gradio",
                        lambda model, args: launched.append(args.port))
    with mock.patch.dict(sys.modules, {"gradio": fake}):
        app_gradio.main(["--save-dir", str(tmp_path / "s"), "--port",
                         "7861", "--device", "cpu"])
    assert launched == [7861]
