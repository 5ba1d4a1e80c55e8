"""GPT-2 byte-level BPE tokenizer with OPT conventions (counterpart of the
OPT tokenizer in gill_tpu/tokenizer.py, the part the inference path uses).

Given the standard `vocab.json` + `merges.txt` it reproduces the HF OPT
tokenizer; `GPT2BPETokenizer.tiny()` builds an in-memory byte-level
vocabulary (no merges) for tests. Each word's merges run in the native
C++ engine (`gill_tpu_torch.native`, as gill_tpu's do) where g++ builds
it, else in Python; both give the same ids. OPT conventions: "<s>"=0,
"<pad>"=1, "</s>"=2, "<unk>"=3; bos == eos == "</s>"; added tokens
("<|image|>", "[IMG0..n)") are appended at the end of the vocabulary. A CPU test holds
its ids and decoded strings equal to gill_tpu's tokenizer.

`CLIPBPETokenizer` is Stable Diffusion's prompt tokenizer (CLIP's BPE:
lowercased, "</w>" word ends, <|startoftext|> / <|endoftext|>, padded to
77 with the end token), read from a diffusers `tokenizer/` directory.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import regex as re

from gill_tpu_torch.native import get_bpe_engine

# GPT-2's tokenization regex.
_PAT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> unicode-char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class Encoding:
    """Minimal stand-in for HF BatchEncoding."""

    def __init__(self, input_ids, attention_mask):
        self.input_ids = input_ids
        self.attention_mask = attention_mask

    def __getitem__(self, k):
        return getattr(self, k)


class GPT2BPETokenizer:
    """Byte-level BPE with HF-OPT-compatible special-token handling."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[str],
        bos_token: str = "</s>",
        eos_token: str = "</s>",
        pad_token: Optional[str] = "<pad>",
        unk_token: str = "<unk>",
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._bpe_cache: Dict[str, str] = {}
        self._id_cache: Dict[str, List[int]] = {}

        # The native (C++) merge engine for the hot path; None -> the
        # Python BPE below (no compiler, no merges, or an exotic vocab).
        self._native = get_bpe_engine(self.encoder, self.bpe_ranks)

        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token = unk_token
        self.pad_token = pad_token if (pad_token in self.encoder) else None
        self.cls_token: Optional[str] = None

        # Added tokens (matched greedily before BPE), e.g. [IMG0..7], <|image|>.
        self.added_tokens: Dict[str, int] = {}
        self.special_token_strs = {bos_token, eos_token, unk_token}
        if self.pad_token:
            self.special_token_strs.add(self.pad_token)
        self._added_pat = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "GPT2BPETokenizer":
        with open(vocab_file) as f:
            vocab = json.load(f)
        with open(merges_file) as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#version"):
            merges = merges[1:]
        return cls(vocab, [m for m in merges if m], **kw)

    @classmethod
    def from_pretrained_dir(cls, path: str, **kw) -> "GPT2BPETokenizer":
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    @classmethod
    def tiny(cls) -> "GPT2BPETokenizer":
        """In-memory byte-level vocab (no merges) with OPT special-token
        layout: ids 0..3 specials, 4..259 raw bytes. Used by tests."""
        vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
        for i, ch in enumerate(bytes_to_unicode().values()):
            vocab[ch] = 4 + i
        return cls(vocab, merges=[])

    # -- core BPE ------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token)
        if len(word) < 2 or not self.bpe_ranks:
            self._bpe_cache[token] = token if len(word) < 2 else " ".join(word)
            return self._bpe_cache[token]
        pairs = _get_pairs(word)
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def _encode_ordinary(self, text: str) -> List[int]:
        ids: List[int] = []
        unk_id = self.encoder.get(self.unk_token, 3)
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            cached = self._id_cache.get(tok)
            if cached is not None:
                ids.extend(cached)
                continue
            if self._native is not None:
                out = self._native.encode(
                    [self.encoder.get(c, unk_id) for c in tok])
            else:
                out = [self.encoder.get(piece, unk_id)
                       for piece in self._bpe(tok).split(" ")]
            self._id_cache[tok] = out
            ids.extend(out)
        return ids

    def _split_on_added(self, text: str) -> List[str]:
        if not self.added_tokens:
            return [text]
        if self._added_pat is None:
            toks = sorted(self.added_tokens, key=len, reverse=True)
            self._added_pat = re.compile("(" + "|".join(re.escape(t) for t in toks) + ")")
        return [s for s in self._added_pat.split(text) if s]

    # -- public HF-compatible surface -----------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for seg in self._split_on_added(text):
            if seg in self.added_tokens:
                ids.append(self.added_tokens[seg])
            else:
                ids.extend(self._encode_ordinary(seg))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text: Union[str, Sequence[str]],
                 add_special_tokens: bool = True,
                 padding: Optional[str] = None, truncation: bool = False,
                 max_length: Optional[int] = None,
                 return_tensors: Optional[str] = None) -> Encoding:
        """HF-style call: ids and masks, truncated / padded to max_length
        when asked; lists of lists (one text: one list) unless
        return_tensors="np" (int32 arrays)."""
        texts = [text] if isinstance(text, str) else list(text)
        all_ids, all_mask = [], []
        for t in texts:
            ids = self.encode(t, add_special_tokens=add_special_tokens)
            if truncation and max_length is not None:
                ids = ids[:max_length]
            mask = [1] * len(ids)
            if padding == "max_length" and max_length is not None:
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            all_ids.append(ids)
            all_mask.append(mask)
        if return_tensors == "np":
            return Encoding(np.asarray(all_ids, np.int32),
                            np.asarray(all_mask, np.int32))
        if isinstance(text, str) and return_tensors is None:
            return Encoding(all_ids[0], all_mask[0])
        return Encoding(all_ids, all_mask)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        try:
            ids = [int(i) for i in ids]
        except TypeError:
            ids = [int(ids)]
        special_ids = self.all_special_ids if skip_special_tokens else set()
        text_chunks: List[str] = []
        byte_buf: List[str] = []

        def flush():
            if byte_buf:
                s = "".join(byte_buf)
                text_chunks.append(
                    bytearray(self.byte_decoder[c] for c in s).decode("utf-8", errors="replace")
                )
                byte_buf.clear()

        added_rev = {v: k for k, v in self.added_tokens.items()}
        for i in ids:
            if i in special_ids:
                continue
            if i in added_rev:
                flush()
                if not (skip_special_tokens and added_rev[i] in self.special_token_strs):
                    text_chunks.append(added_rev[i])
                continue
            tok = self.decoder.get(i)
            if tok is None:
                continue
            if tok in self.special_token_strs:
                flush()
                if not skip_special_tokens:
                    text_chunks.append(tok)
                continue
            byte_buf.append(tok)
        flush()
        return "".join(text_chunks)

    def batch_decode(self, batch_ids,
                     skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(ids, skip_special_tokens=skip_special_tokens)
                for ids in batch_ids]

    def add_tokens(self, token: Union[str, Sequence[str]]) -> int:
        toks = [token] if isinstance(token, str) else list(token)
        n = 0
        for t in toks:
            if t in self.encoder or t in self.added_tokens:
                continue
            self.added_tokens[t] = len(self)
            self._added_pat = None
            n += 1
        return n

    def add_special_tokens(self, mapping: Dict[str, str]) -> int:
        n = 0
        for key, tok in mapping.items():
            n += self.add_tokens(tok)
            setattr(self, key, tok)
            self.special_token_strs.add(tok)
        return n

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.encoder.get(token, self.encoder.get(self.unk_token, 3))

    # -- attributes ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def bos_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        if self.pad_token is not None and self.pad_token in self.encoder:
            return self.encoder[self.pad_token]
        return self.eos_token_id  # reference main.py:260 fallback

    @pad_token_id.setter
    def pad_token_id(self, v: int):
        self.pad_token = self.decoder.get(v, self.pad_token)

    @property
    def cls_token_id(self) -> Optional[int]:
        if self.cls_token is None:
            return None
        return self.convert_tokens_to_ids(self.cls_token)

    @property
    def all_special_ids(self):
        out = set()
        for t in self.special_token_strs:
            if t in self.encoder:
                out.add(self.encoder[t])
            elif t in self.added_tokens:
                out.add(self.added_tokens[t])
        return out


def setup_gill_tokenizer(tokenizer: GPT2BPETokenizer, num_tokens: int = 8) -> List[int]:
    """Registers <|image|> (cls) and [IMG0..n) tokens; returns [IMG] ids.

    Mirrors reference main.py:262-280 / gill/models.py:848-862.
    """
    tokenizer.add_special_tokens({"cls_token": "<|image|>"})
    img_ids = []
    for i in range(num_tokens):
        tokenizer.add_tokens(f"[IMG{i}]")
        img_ids.append(tokenizer.convert_tokens_to_ids(f"[IMG{i}]"))
    return img_ids


class CLIPBPETokenizer:
    """CLIP's byte-level BPE, Stable Diffusion's prompt tokenizer
    (gill_tpu tokenizer.py CLIPBPETokenizer).

    Against GPT-2's BPE: lowercasing and whitespace cleanup, an "</w>"
    end-of-word marker on each word's last symbol, <|startoftext|> /
    <|endoftext|> specials, padding with the end token (SD v1.5's
    convention). The SD pipeline's `encode_text` and its unconditional
    embedding use it (reference custom_sd.py:594-604)."""

    PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", re.IGNORECASE)

    def __init__(self, vocab: Dict[str, int], merges: Sequence[str],
                 max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._cache: Dict[str, str] = {}
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id
        self.model_max_length = max_length

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw):
        with open(vocab_file) as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#version"):
            merges = merges[1:]
        return cls(vocab, [m for m in merges if m], **kw)

    @classmethod
    def tiny(cls) -> "CLIPBPETokenizer":
        """Byte-level vocab with </w> variants and no merges (514 ids;
        <|endoftext|> is 513, tiny_sd_config's text eos); for tests."""
        vocab = {}
        for ch in bytes_to_unicode().values():
            vocab[ch] = len(vocab)
        for ch in bytes_to_unicode().values():
            vocab[ch + "</w>"] = len(vocab)
        vocab["<|startoftext|>"] = len(vocab)
        vocab["<|endoftext|>"] = len(vocab)
        return cls(vocab, merges=[])

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1 or not self.bpe_ranks:
            out = " ".join(word)
            self._cache[token] = out
            return out
        pairs = _get_pairs(word)
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        import re as _re

        text = _re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for tok in self.PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok).split(" "):
                ids.append(self.encoder.get(piece, self.eos_token_id))
        return ids

    def __call__(self, text: Union[str, Sequence[str]],
                 max_length: Optional[int] = None,
                 truncate_side: str = "right") -> Encoding:
        """(B, max_length) int32 input_ids / attention_mask: <|startoftext|>,
        the ids cut to max_length - 2 from the `truncate_side` end (the
        reference's tokenizer fork, custom_sd.py:90,169,268-275),
        <|endoftext|>, then the pad id."""
        texts = [text] if isinstance(text, str) else list(text)
        max_length = max_length or self.model_max_length
        all_ids, all_mask = [], []
        for t in texts:
            ids = self.encode(t)
            if len(ids) > max_length - 2:
                if truncate_side == "right":
                    ids = ids[: max_length - 2]
                else:
                    ids = ids[-(max_length - 2):]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            mask = [1] * len(ids) + [0] * (max_length - len(ids))
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
            all_ids.append(ids)
            all_mask.append(mask)
        return Encoding(np.asarray(all_ids, np.int32),
                        np.asarray(all_mask, np.int32))


def load_tokenizer(name_or_dir: str) -> GPT2BPETokenizer:
    """Loads a tokenizer from a local directory with vocab.json/merges.txt.

    `name_or_dir` may be an HF-style name; we look for the files in
    (1) the path itself, (2) $GILL_TPU_TOKENIZER_DIR, (3) ./tokenizer_assets.
    """
    candidates = [name_or_dir]
    env = os.environ.get("GILL_TPU_TOKENIZER_DIR")
    if env:
        candidates.append(env)
        candidates.append(os.path.join(env, name_or_dir.replace("/", "--")))
    candidates.append(os.path.join("tokenizer_assets", name_or_dir.replace("/", "--")))
    for c in candidates:
        if os.path.isdir(c) and os.path.exists(os.path.join(c, "vocab.json")):
            return GPT2BPETokenizer.from_pretrained_dir(c)
    raise FileNotFoundError(
        f"No tokenizer files (vocab.json/merges.txt) found for {name_or_dir!r}; "
        f"searched {candidates}. Set GILL_TPU_TOKENIZER_DIR or pass a directory."
    )
