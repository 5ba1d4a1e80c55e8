"""Data pipeline: TSV (caption \\t image) -> fixed-shape numpy batches
(gill_tpu/data/dataset.py; reference CsvDataset + torch DataLoader,
gill/data.py:70-144).

Per item: image pixels (CLIP-normalized NHWC), the precomputed SD text
embedding (num_clip_tokens, 768) from `<image_dir>/clip_embs/<image>.npy`,
the caption tokenized to max_len with the appended [IMG0..n) run repaired
if truncation clobbered it, the caption length and, with
`render_caption=True`, the decoded caption rendered as an image
(`caption_img`, for TensorBoard grids; the trainer does not ask for it).

Batches are numpy dicts on the host, loaded by a background thread pool
that prefetches ahead of the step loop; the trainer moves them to the
device (`train/trainer.py put_batch`). The same seed gives gill_tpu's
batches: the same RandomState shuffle and per-item substitute streams.
JPEG and PNG images are decoded and preprocessed by the native C++ engine
(`gill_tpu_torch.native.decode_preprocess`, gill_tpu's arithmetic: its
resample is within ~2/255 of PIL's), on by default as in gill_tpu;
GILL_NO_NATIVE_IMAGE=1 turns it off, and without the engine (no g++,
libjpeg or libpng) the loader says so once and decodes with PIL. Bad
samples retry with a random substitute (reference gill/data.py:141-144).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
from PIL import Image

from gill_tpu_torch.utils import image as image_utils


class TsvDataset:
    _warned_native_fallback = False

    def __init__(self, tsv_path: str, image_dir: str, tokenizer,
                 img_token_ids: List[int], max_len: int = 32,
                 image_size: int = 224, num_clip_tokens: int = 77,
                 gen_emb_dim: int = 768, render_caption: bool = False):
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.img_token_ids = list(img_token_ids)
        self.max_len = max_len
        self.image_size = image_size
        self.num_clip_tokens = num_clip_tokens
        self.gen_emb_dim = gen_emb_dim
        self.render_caption = render_caption
        self._use_native = os.environ.get("GILL_NO_NATIVE_IMAGE") != "1"

        self.images: List[str] = []
        self.captions: List[str] = []
        with open(tsv_path, newline="") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for row in reader:
                self.images.append(str(row["image"]))
                self.captions.append(str(row["caption"]))
        if len(self.images) != len(self.captions):
            raise ValueError(f"{tsv_path}: ragged rows")

    def __len__(self) -> int:
        return len(self.captions)

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        image_path = os.path.join(self.image_dir, self.images[idx])
        caption = self.captions[idx]
        emb_path = os.path.join(self.image_dir, "clip_embs",
                                self.images[idx] + ".npy")

        pixels = self._native_pixels(image_path) if self._use_native \
            else None
        if pixels is None:
            with Image.open(image_path) as img:
                pixels = image_utils.clip_preprocess(img, self.image_size)

        clip_emb = np.load(emb_path, allow_pickle=True)
        clip_emb = np.asarray(clip_emb, np.float32)[: self.num_clip_tokens]

        cap = caption + "".join(f"[IMG{i}]" for i in range(len(self.img_token_ids)))
        enc = self.tokenizer(cap, padding="max_length", truncation=True,
                             max_length=self.max_len)
        tokens = np.asarray(enc.input_ids, np.int32)
        caption_len = int(np.sum(enc.attention_mask))
        # Repair the [IMG] tail if truncation clobbered it
        # (reference gill/data.py:133-134).
        if tokens[-1] not in (self.tokenizer.pad_token_id, self.img_token_ids[-1]):
            tokens[-len(self.img_token_ids):] = self.img_token_ids
            caption_len = self.max_len

        item = {
            "path": image_path,
            "pixels": pixels,
            "ret_tokens": tokens,
            "ret_len": np.int32(caption_len),
            "gen_tokens": tokens,
            "gen_len": np.int32(caption_len),
            "clip_emb": clip_emb,
        }
        if self.render_caption:
            decoded = self.tokenizer.decode(tokens)
            item["caption_img"] = image_utils.create_image_of_text(
                decoded.encode("ascii", "ignore"), width=self.image_size)
        return item

    def _native_pixels(self, image_path: str):
        """The native engine's pixels, or None for PIL to decode: where the
        engine is unavailable (said once, then PIL for every item), the
        file is not a JPEG / PNG, or its decode fails."""
        from gill_tpu_torch import native

        if not native.image_engine_available():
            self._use_native = False
            if not TsvDataset._warned_native_fallback:
                TsvDataset._warned_native_fallback = True
                print("gill_tpu_torch: native image engine unavailable; "
                      "using PIL (GILL_NO_NATIVE_IMAGE=1 silences this)",
                      flush=True)
            return None
        with open(image_path, "rb") as f:
            raw = f.read()
        try:
            return native.decode_preprocess(
                raw, self.image_size, image_utils.CLIP_MEAN.reshape(-1),
                image_utils.CLIP_STD.reshape(-1))
        except (ValueError, RuntimeError):
            return None

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None):
        """Load with infinite retry on bad samples (random substitute)."""
        rng = rng or np.random
        while True:
            try:
                return self._load_one(idx)
            except Exception as e:  # noqa: BLE001
                print(f"Error reading {self.images[idx]}: {e}")
                # exclusive upper bound: len(self) keeps the LAST sample
                # reachable as a substitute (and len==1 would crash)
                idx = int(rng.randint(0, len(self)))


def get_dataset(args, split: str, tokenizer, img_token_ids) -> TsvDataset:
    """Reference get_dataset (gill/data.py:24-67): cc3m TSV layout."""
    if split not in ("train", "val"):
        raise ValueError(f"split {split!r}")
    name = args.dataset if split == "train" else args.val_dataset
    if "cc3m" not in name:
        raise NotImplementedError(name)
    sub = "cc3m/training" if split == "train" else "cc3m/validation"
    return TsvDataset(
        os.path.join(args.dataset_dir, f"cc3m_{split}.tsv"),
        os.path.join(args.image_dir, sub),
        tokenizer, img_token_ids, max_len=args.max_len,
        image_size=getattr(args, "image_size", 224),
        num_clip_tokens=getattr(args, "num_clip_tokens", 77),
        gen_emb_dim=getattr(args, "gen_emb_dim", 768))


class DataLoader:
    """Threaded prefetching batch iterator with fixed-shape numpy outputs.

    drop_last semantics; `shard(rank, world)` restricts to a contiguous
    interleaved shard (DistributedSampler equivalent, reference main.py:377).
    """

    def __init__(self, dataset: TsvDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, num_threads: int = 2,
                 prefetch: int = 2, rank: int = 0, world: int = 1,
                 drop_last: bool = True):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.rank, self.world = rank, world
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.world > 1:
            # Equalize per-rank counts by wrapping (torch DistributedSampler
            # semantics): ragged tails give ranks different batch counts, and
            # a collective eval step / process_allgather then hangs waiting
            # on ranks that ran out of batches.
            total = -(-len(idx) // self.world) * self.world
            if total > len(idx):
                idx = np.concatenate([idx, idx[:total - len(idx)]])
        return idx[self.rank::self.world]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _collate(self, items) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for k in items[0]:
            if k == "path":
                out[k] = [it[k] for it in items]
            else:
                out[k] = np.stack([np.asarray(it[k]) for it in items])
        return out

    def _load_item(self, i: int):
        # Per-item RandomState: deterministic regardless of thread
        # interleaving (the rng only draws bad-sample substitutes) and safe
        # to use from pool workers (np RandomState is not thread-shareable).
        r = np.random.RandomState(
            (self.seed + 7919 * self.epoch + int(i)) % (2 ** 31))
        return self.ds.get(int(i), r)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = None
        if self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(self.num_threads,
                                      thread_name_prefix="gill-data")

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone — a
            plain q.put on the full queue blocks forever after an early
            consumer exit (one leaked thread + prefetched batches per
            truncated epoch)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    batch_idx = indices[b * self.bs:(b + 1) * self.bs]
                    if pool is not None:
                        items = list(pool.map(self._load_item, batch_idx))
                    else:
                        items = [self._load_item(i) for i in batch_idx]
                    if not put(self._collate(items)):
                        return
            except Exception as e:  # noqa: BLE001 — surfaced to consumer;
                # swallowing it here would end the epoch as if complete
                put(("__error__", e))
                return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, tuple) and len(batch) == 2 \
                        and batch[0] == "__error__":
                    raise RuntimeError("data loader worker failed"
                                       ) from batch[1]
                yield batch
        finally:
            stop.set()
            if pool is not None:
                pool.shutdown(wait=False)


def make_stub_dataset(root: str, n: int = 8, image_size: int = 32,
                      num_clip_tokens: int = 8, gen_emb_dim: int = 12,
                      split: str = "train") -> str:
    """Synthesizes a tiny cc3m-layout dataset (tsv + images + clip_embs) for
    tests and the CPU smoke config. Returns the dataset root."""
    img_dir = os.path.join(root, f"cc3m/{'training' if split == 'train' else 'validation'}")
    os.makedirs(os.path.join(img_dir, "clip_embs"), exist_ok=True)
    os.makedirs(os.path.join(root, "datasets"), exist_ok=True)
    tsv = os.path.join(root, "datasets", f"cc3m_{split}.tsv")
    rng = np.random.RandomState(0 if split == "train" else 1)
    words = ["a", "dog", "cat", "red", "house", "tree", "small", "big"]
    with open(tsv, "w") as f:
        f.write("caption\timage\n")
        for i in range(n):
            name = f"{split}_{i}.png"
            arr = rng.randint(0, 255, (image_size, image_size, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, name))
            emb = rng.randn(num_clip_tokens, gen_emb_dim).astype(np.float16)
            np.save(os.path.join(img_dir, "clip_embs", name + ".npy"), emb)
            cap = " ".join(rng.choice(words, rng.randint(2, 6)))
            f.write(f"{cap}\t{name}\n")
    return root
