"""Writes the GPT-2-style byte-level BPE fixture `vocab.json` + `merges.txt`
(the files of tests/fixtures/tok/) by running the standard BPE training
algorithm (Sennrich-style greedy pair merging over the GPT-2
pre-tokenization) on a small mixed corpus (counterpart of
scripts/make_tokenizer_fixture.py).

    python -m gill_tpu_torch.scripts.make_tokenizer_fixture [OUT_DIR]

OUT_DIR defaults to tests/fixtures/tok. The vocabulary layout mirrors
OPT / GPT-2: the byte alphabet, the learned merges, then <|endoftext|>.
Deterministic: a run reproduces the committed files byte for byte.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

from gill_tpu_torch.tokenizer import _PAT, bytes_to_unicode

CORPUS = """
A picture of a dog playing in the park. The quick brown fox jumps over the
lazy dog. I think this is unbelievable! Numbers like 1234 and 42 appear,
as do contractions: don't, can't, we're, I'll, it's, you've, I'm, he'd.
Multiple   spaces and
newlines and	tabs. Punctuation?! (Yes; really...) "Quoted strings" and
[brackets] and {braces} and <angles>. CamelCaseWords and snake_case_words
and kebab-case-words. Unicode: café, naïve, 北京, Москва, emoji 🙂 too.
the the the the of of of and and a a a in in to to is is was was it it
picture picture image image generation retrieval model token embedding
What is the weather today? Answer: sunny with a chance of rain.
Q: show me a photo of a cat
A: here is a cat sitting on a windowsill.
"""

NUM_MERGES = 400
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "fixtures", "tok")


def train_bpe(corpus: str, num_merges: int):
    """(vocab, merges) of `num_merges` greedy merges over `corpus`."""
    byte_enc = bytes_to_unicode()
    words = collections.Counter()
    for tok in _PAT.findall(corpus):
        sym = tuple(byte_enc[b] for b in tok.encode("utf-8"))
        if sym:
            words[sym] += 1

    merges = []
    for _ in range(num_merges):
        pairs = collections.Counter()
        for word, freq in words.items():
            for a, b in zip(word, word[1:]):
                pairs[(a, b)] += freq
        if not pairs:
            break
        # deterministic argmax: frequency, then the shorter merge, then
        # the larger pair
        best = max(pairs, key=lambda p: (pairs[p], (-len(p[0] + p[1]),), p))
        merges.append(best)
        merged = best[0] + best[1]
        new_words = collections.Counter()
        for word, freq in words.items():
            out, i = [], 0
            while i < len(word):
                if (i + 1 < len(word) and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_words[tuple(out)] += freq
        words = new_words

    vocab = {}
    for ch in byte_enc.values():
        vocab[ch] = len(vocab)
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def write_fixture(out_dir: str) -> tuple:
    """Writes vocab.json and merges.txt into `out_dir`; returns (vocab
    entries, merges)."""
    os.makedirs(out_dir, exist_ok=True)
    vocab, merges = train_bpe(CORPUS, NUM_MERGES)
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return len(vocab), len(merges)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    n_vocab, n_merges = write_fixture(args.out_dir)
    print(f"wrote {n_vocab} vocab entries, {n_merges} merges to "
          f"{args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
