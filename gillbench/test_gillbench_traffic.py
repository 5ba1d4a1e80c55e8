"""The general traffic generator: deterministic a seed, the same sizes for
every seed, and the mix's stated ranges."""

import statistics

import numpy as np

from gillbench import harness, traffic


def _mix(name):
    return harness.load_json(f"{harness.BENCH_DIR}/traffic/{name}.json")


def test_uniform_sizes_cover_the_range():
    s = traffic.uniform_sizes(120, 400, 256)
    assert s == sorted(s) and 120 <= min(s) and max(s) <= 400
    assert abs(statistics.mean(s) - 260) <= 1


def test_gill_prompts_deterministic_and_sized():
    mix = dict(_mix("gen_c32"), pool=32)
    a = traffic.gill_prompts(mix, 123456789012)
    b = traffic.gill_prompts(mix, 123456789012)
    c = traffic.gill_prompts(mix, 1)
    assert all(np.array_equal(x["image"], y["image"]) and x["text"] ==
               y["text"] for x, y in zip(a, b))
    lo, hi = mix["dialogue"]["text_bytes"]
    for p in a:
        n = len(p["text"].encode())
        assert lo - 3 <= n <= hi + 3 and p["text"].endswith("\nA:")
        assert p["image"].shape == (256, 256, 3)
    assert sorted(len(p["text"]) for p in a) == sorted(len(p["text"])
                                                       for p in c)
    # prompt + the [IMG] decode fit the engine's rows
    eng, rq = mix["engine"], mix["request"]
    assert hi + 1 + 4 + rq["num_words"] + 8 <= eng["max_seq"]
