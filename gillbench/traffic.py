"""The general traffic generator: a mix file's parameters in, requests out.

Sizes are a fixed set spread over the mix's range, the same for every seed;
--seed decides their order and the content (images, words). So two seeds
send the same work in another order, and runs of different seeds spread no
more than runs of one.
"""

from __future__ import annotations

from typing import List

import numpy as np

WORDS = ("the a an of and to in on with by at from near under over "
         "picture photo image drawing painting dog cat bird horse boat car "
         "street house garden lake river mountain beach forest city sky "
         "red blue green yellow white black small large old young bright "
         "dark sunny rainy evening morning night people man woman child "
         "sitting standing walking running holding looking next behind "
         "wooden stone glass table chair window door tree flower grass "
         "what where how many is are there does do can you show me").split()


def uniform_sizes(lo: int, hi: int, n: int) -> List[int]:
    """n sizes evenly over [lo, hi]."""
    return [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def dialogue(r: np.random.Generator, nbytes: int, words: tuple) -> str:
    """A VisDial-style exchange about an image: question / answer lines of
    `words` seeded words each, cut so the text is `nbytes` bytes, ending
    on the answer's "A:"."""
    lines, size, t = [], 0, 0
    while size < nbytes:
        k = int(r.integers(words[0], words[1] + 1))
        line = ("Q: " if t % 2 == 0 else "A: ") + " ".join(
            WORDS[int(j)] for j in r.integers(0, len(WORDS), k))
        lines.append(line)
        size += len(line) + 1
        t += 1
    return "\n".join(lines)[: max(nbytes - 3, 1)] + "\nA:"


def gill_prompts(mix: dict, seed: int) -> List[dict]:
    """The pool of a GILL mix: a seeded RGB image and a dialogue a prompt,
    text sizes evenly over the mix's range."""
    n = mix["pool"]
    lo, hi = mix["dialogue"]["text_bytes"]
    sizes = uniform_sizes(lo, hi, n)
    r = rng(seed, 2)
    order = r.permutation(n)
    side = mix["image"]["size"]
    out = []
    for i in range(n):
        img = r.integers(0, 256, (side, side, 3), dtype=np.uint8)
        out.append({"image": img,
                    "text": dialogue(r, sizes[order[i]],
                                     tuple(mix["dialogue"]["line_words"])),
                    "sd_seed": int(r.integers(0, 2 ** 62))})
    return out
