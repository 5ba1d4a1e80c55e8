"""The port's native host engines (gill_tpu_torch/native: the C++ BPE merge
loop and JPEG / PNG decode + CLIP preprocess) against gill_tpu's
(gill_tpu/native), and the tokenizer and training loader that use them,
on the CPU.

Tolerances:
  * `decode_preprocess`: bit for bit gill_tpu's (the same arithmetic, both
    built by g++ -O2 -std=c++17), and within 0.02 of the PIL path's
    `clip_preprocess` on CLIP-normalized values (tests/test_native_image.py:
    PIL resamples uint8 in 8-bit fixed point); bytes of no known format
    give None;
  * BPE ids: equal to gill_tpu's tokenizer (its engine on) and to the
    port's Python path, on tests/fixtures/tok and on random merges;
  * `TsvDataset` batches (JPEG, PNG and a GIF that takes the per-file PIL
    path), native on and under GILL_NO_NATIVE_IMAGE=1: every key equal to
    gill_tpu's under the same setting and seed, `caption_img` included.
Where g++, libjpeg or libpng is missing, the engine tests skip with the
compiler's reason (decided in a fixture).
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "tok")
TOL = 0.02


@pytest.fixture(scope="module")
def bpe_engines():
    from gill_tpu import native as jnative
    from gill_tpu_torch import native

    if native.bpe_lib() is None:
        pytest.skip(f"native BPE engine unavailable: "
                    f"{native.build_error('bpe')}")
    if jnative._load_lib() is None:
        pytest.skip("gill_tpu's native BPE engine unavailable")
    return native, jnative


@pytest.fixture(scope="module")
def image_engines():
    from gill_tpu import native as jnative
    from gill_tpu_torch import native

    if native.image_lib() is None:
        pytest.skip(f"native image engine unavailable: "
                    f"{native.build_error('image')}")
    if jnative._load_image_lib() is None:
        pytest.skip("gill_tpu's native image engine unavailable")
    return native, jnative


def _encoded(fmt, wh, seed, mode="RGB"):
    rng = np.random.RandomState(seed)
    if mode == "L":
        img = Image.fromarray(rng.randint(0, 255, (wh[1], wh[0]), np.uint8),
                              "L")
    else:
        img = Image.fromarray(rng.randint(0, 255, (wh[1], wh[0], 3),
                                          np.uint8))
        if mode == "P":
            img = img.convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    img.save(buf, fmt, quality=95)
    return buf.getvalue()


IMAGE_CASES = [("JPEG", (320, 240), "RGB", 224), ("JPEG", (37, 61), "RGB", 32),
               ("JPEG", (100, 467), "RGB", 64), ("PNG", (224, 224), "RGB", 224),
               ("PNG", (61, 37), "RGB", 32), ("PNG", (128, 96), "L", 64),
               ("PNG", (128, 96), "P", 64)]


@pytest.mark.parametrize("case", IMAGE_CASES,
                         ids=[f"{f}-{m}-{w}x{h}-{s}"
                              for f, (w, h), m, s in IMAGE_CASES])
def test_decode_preprocess_is_gill_tpus(image_engines, monkeypatch, case):
    from gill_tpu_torch.utils import image as iu

    native, jnative = image_engines
    monkeypatch.delenv("GILL_NO_NATIVE_IMAGE", raising=False)
    fmt, wh, mode, size = case
    data = _encoded(fmt, wh, IMAGE_CASES.index(case), mode)
    mean, std = iu.CLIP_MEAN.reshape(-1), iu.CLIP_STD.reshape(-1)
    got = native.decode_preprocess(data, size, mean, std)
    want = jnative.decode_preprocess(data, size, mean, std)
    assert got.dtype == np.float32 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    ref = iu.clip_preprocess(Image.open(io.BytesIO(data)), size)
    assert np.abs(got - ref).max() < TOL


def test_bad_bytes_and_the_opt_out_give_none(image_engines, monkeypatch):
    from gill_tpu_torch.utils import image as iu

    native, _ = image_engines
    mean, std = iu.CLIP_MEAN.reshape(-1), iu.CLIP_STD.reshape(-1)
    for bad in (b"not an image", b"\xff\xd8\xffgarbage",
                _encoded("GIF", (16, 16), 0)):
        assert native.decode_preprocess(bad, 32, mean, std) is None
    monkeypatch.setenv("GILL_NO_NATIVE_IMAGE", "1")
    assert not native.image_engine_available()
    assert native.decode_preprocess(_encoded("PNG", (8, 8), 0), 8, mean,
                                    std) is None


def _random_merges(seed):
    from gill_tpu_torch.tokenizer import bytes_to_unicode

    rng = np.random.RandomState(seed)
    b2u = bytes_to_unicode()
    chars = [b2u[ord(ch)] for ch in "abcdefgh "]
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in chars:
        vocab[ch] = len(vocab)
    merges, symbols = [], list(chars)
    for _ in range(40):
        left, right = rng.choice(symbols, 2)
        if left + right not in vocab:
            vocab[left + right] = len(vocab)
            merges.append(f"{left} {right}")
            symbols.append(left + right)
    texts = ["".join(rng.choice(list("abcdefgh "), rng.randint(1, 40)))
             for _ in range(60)]
    return vocab, merges, texts


def _fixture_case():
    import json

    with open(os.path.join(FIXTURE, "vocab.json")) as f:
        vocab = json.load(f)
    with open(os.path.join(FIXTURE, "merges.txt")) as f:
        merges = [m for m in f.read().split("\n")[1:] if m]
    rng = np.random.RandomState(1)
    words = ["picture", "dog", "the", "café", "北京", "🙂", "unbelievable",
             "don't", "1234", "snake_case", "Москва", "windowsill", "zzqx"]
    texts = [" ".join(rng.choice(words, rng.randint(1, 30)))
             for _ in range(30)]
    return vocab, merges, texts


@pytest.mark.parametrize("which", ["fixture", "random_merges"])
def test_bpe_ids_equal_gill_tpus_and_python(bpe_engines, which):
    from gill_tpu.tokenizer import GPT2BPETokenizer as JTok
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer

    vocab, merges, texts = (_fixture_case() if which == "fixture"
                            else _random_merges(0))
    nat = GPT2BPETokenizer(dict(vocab), list(merges))
    py = GPT2BPETokenizer(dict(vocab), list(merges))
    py._native = None
    ref = JTok(dict(vocab), list(merges))
    assert nat._native is not None and ref._native is not None
    for s in texts:
        got = nat.encode(s, add_special_tokens=False)
        assert got == py.encode(s, add_special_tokens=False), s
        assert got == ref.encode(s, add_special_tokens=False), s
    ids = nat.encode(texts[0], add_special_tokens=False)
    assert nat.decode(ids) == ref.decode(ids) == texts[0]


def test_engine_refuses_merges_outside_the_vocab(bpe_engines):
    native, _ = bpe_engines
    from gill_tpu_torch.tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    a, b = b2u[ord("a")], b2u[ord("b")]
    assert native.get_bpe_engine({a: 0, b: 1}, {(a, b): 0}) is None
    assert native.get_bpe_engine({a: 0, b: 1}, {}) is None
    assert native.get_bpe_engine({a: 0, b: 1, a + b: 2},
                                 {(a, b): 0}).encode([0, 1, 0]) == [2, 0]


def _dataset_dir(root):
    """A cc3m-layout split of JPEGs, PNGs of several sizes and a GIF (the
    per-file PIL path), one caption long enough to be cut."""
    rng = np.random.RandomState(4)
    d = os.path.join(root, "cc3m", "training")
    os.makedirs(os.path.join(d, "clip_embs"), exist_ok=True)
    rows = []
    specs = [("JPEG", (48, 40)), ("PNG", (40, 40)), ("JPEG", (31, 57)),
             ("GIF", (36, 30)), ("PNG", (70, 33)), ("JPEG", (40, 40))]
    words = ["a", "dog", "cat", "red", "house", "tree", "small", "big"]
    for i, (fmt, wh) in enumerate(specs):
        name = f"im{i}.{fmt.lower()}"
        with open(os.path.join(d, name), "wb") as f:
            f.write(_encoded(fmt, wh, 10 + i))
        np.save(os.path.join(d, "clip_embs", name + ".npy"),
                rng.randn(6, 12).astype(np.float16))
        n = 20 if i == 2 else rng.randint(2, 6)
        rows.append((" ".join(rng.choice(words, n)), name))
    tsv = os.path.join(root, "train.tsv")
    with open(tsv, "w") as f:
        f.write("caption\timage\n")
        for cap, name in rows:
            f.write(f"{cap}\t{name}\n")
    return tsv, d


def _batches(ds_mod, tok_mod, tsv, d):
    tok = tok_mod.GPT2BPETokenizer.tiny()
    ids = tok_mod.setup_gill_tokenizer(tok, 4)
    ds = ds_mod.TsvDataset(tsv, d, tok, ids, max_len=16, image_size=32,
                           num_clip_tokens=6, gen_emb_dim=12,
                           render_caption=True)
    return list(ds_mod.DataLoader(ds, 2, shuffle=True, seed=3,
                                  num_threads=2))


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "pil"])
def test_dataset_batches_equal_gill_tpus(image_engines, tmp_path,
                                         monkeypatch, native_on):
    from gill_tpu import tokenizer as jtok
    from gill_tpu.data import dataset as jds
    from gill_tpu_torch import tokenizer as ttok
    from gill_tpu_torch.data import dataset as tds

    if native_on:
        monkeypatch.delenv("GILL_NO_NATIVE_IMAGE", raising=False)
    else:
        monkeypatch.setenv("GILL_NO_NATIVE_IMAGE", "1")
    tsv, d = _dataset_dir(str(tmp_path))
    got = _batches(tds, ttok, tsv, d)
    want = _batches(jds, jtok, tsv, d)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and "caption_img" in g
        for k in w:
            if k == "path":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if native_on:
        monkeypatch.setenv("GILL_NO_NATIVE_IMAGE", "1")
        pil = _batches(tds, ttok, tsv, d)
        err = max(np.abs(a["pixels"] - b["pixels"]).max()
                  for a, b in zip(got, pil))
        assert 0 < err < TOL


def test_dataset_says_once_that_the_engine_is_missing(tmp_path, monkeypatch,
                                                      capsys):
    from gill_tpu_torch import native
    from gill_tpu_torch import tokenizer as ttok
    from gill_tpu_torch.data import dataset as tds

    monkeypatch.delenv("GILL_NO_NATIVE_IMAGE", raising=False)
    monkeypatch.setattr(native, "image_engine_available", lambda: False)
    monkeypatch.setattr(tds.TsvDataset, "_warned_native_fallback", False)
    tsv, d = _dataset_dir(str(tmp_path))
    a = _batches(tds, ttok, tsv, d)
    b = _batches(tds, ttok, tsv, d)
    assert capsys.readouterr().out.count("native image engine "
                                         "unavailable") == 1
    monkeypatch.setenv("GILL_NO_NATIVE_IMAGE", "1")
    pil = _batches(tds, ttok, tsv, d)
    for x, y, z in zip(a, b, pil):
        np.testing.assert_array_equal(x["pixels"], z["pixels"])
        np.testing.assert_array_equal(y["pixels"], z["pixels"])
