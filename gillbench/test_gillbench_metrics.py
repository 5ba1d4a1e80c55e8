"""The metric arithmetic against hand-worked cases: idle share from interval
unions, kernel-to-span attribution, roofline shares, FLOP counts."""

import pytest
import torch

from gillbench import flops, harness, roofline, trace
from gillbench.metrics_util import idle_share, mfu, roofline_share


class Ev:
    """A stand-in for a Kineto event (the methods trace.reduce_events
    reads)."""

    def __init__(self, name, start, dur, cuda=False, tid=1, corr=0,
                 stream=7, note=False):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._tid, self._c = cuda, tid, corr
        self._stream, self._note = stream, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._c

    def device_resource_id(self):
        return self._stream

    def is_user_annotation(self):
        return self._note


def _slice():
    # span 0 on thread 1 over [0, 100], span 1 on thread 2 over [50, 300],
    # span 2 nested in span 0 over [20, 40]
    spans = [{"name": "unet", "idx": 0, "attrs": {}, "t1": 1},
             {"name": "chunk", "idx": 1, "attrs": {}, "t1": 1},
             {"name": "geglu", "idx": 2, "attrs": {}, "t1": 1}]
    raw = [Ev("gb:0", 0, 100, tid=1), Ev("gb:1", 50, 250, tid=2),
           Ev("gb:2", 20, 20, tid=1),
           Ev("cudaLaunchKernel", 10, 1, tid=1, corr=7),
           Ev("cudaLaunchKernelExC_v11060", 30, 1, tid=1, corr=6),
           Ev("cudaLaunchKernel", 60, 1, tid=2, corr=8),
           Ev("cudaLaunchKernel", 400, 1, tid=2, corr=9),
           Ev("k_a", 1000, 200, cuda=True, corr=7),       # [1000, 1200]
           Ev("k_g", 1200, 50, cuda=True, corr=6),        # [1200, 1250]
           Ev("k_b", 1100, 300, cuda=True, corr=8),       # [1100, 1400]
           Ev("k_c", 2000, 500, cuda=True, corr=9),       # [2000, 2500]
           # the profiler's device-side copy of a range: not a kernel
           Ev("gb:0", 1000, 1500, cuda=True, note=True)]
    return raw, spans


def test_union_attribution_and_gaps():
    raw, spans = _slice()
    red = trace.reduce_events(raw, spans)
    assert red["busy_s"] == pytest.approx((400 + 500) / 1e9)
    assert [k["spans"] for k in red["kernels"]] == [(0,), (1,), (0, 2), ()]
    assert red["attributed"] == 3
    # one gap [1400, 2000], after every span had closed
    assert red["gaps"] == [("none", pytest.approx(600 / 1e9))]
    assert red["device_ops"][0][0] == "k_c"
    assert all(not n.startswith("gb:") for n, _ in red["device_ops"])
    # a span's kernels include those of the spans nested in it
    ms = trace.device_ms_by_span(red, spans, "unet")
    assert ms == {0: pytest.approx(250 / 1e6)}
    assert trace.device_ms_by_span(red, spans, "geglu") == {
        2: pytest.approx(50 / 1e6)}


def test_launch_outside_torch_goes_to_its_wrapper_span():
    """A ctypes launch the profiler files under another thread lands in the
    one wrapper span of its kind open at the launch; where two threads hold
    one, the head dim in the kernel's name decides."""
    spans = [{"name": "unet", "idx": 0, "attrs": {}, "t1": 1},
             {"name": "flash", "idx": 1, "attrs": {"d": 40}, "t1": 1},
             {"name": "clip", "idx": 2, "attrs": {}, "t1": 1},
             {"name": "flash", "idx": 3, "attrs": {"d": 64}, "t1": 1},
             {"name": "geglu", "idx": 4, "attrs": {}, "t1": 1}]
    raw = [Ev("gb:0", 0, 100, tid=2), Ev("gb:1", 10, 30, tid=2),
           Ev("gb:4", 50, 20, tid=2),
           Ev("gb:2", 0, 100, tid=3), Ev("gb:3", 15, 30, tid=3),
           Ev("cudaLaunchKernel", 20, 1, tid=1, corr=5),
           Ev("cudaLaunchKernel", 21, 1, tid=1, corr=6),
           Ev("cudaLaunchKernel", 55, 1, tid=1, corr=7),
           Ev("cudaLaunchKernel", 90, 1, tid=1, corr=8),
           Ev("flash_mma<false, 40, 128, 64, 1>", 1000, 10, cuda=True,
              corr=5),
           Ev("flash_mma<false, 64, 128, 64, 1>", 1010, 10, cuda=True,
              corr=6),
           Ev("geglu_up_wg<1>", 1020, 10, cuda=True, corr=7),
           Ev("geglu_down_wg<1>", 1030, 10, cuda=True, corr=8)]
    owners = (("flash_mma", "flash"), ("geglu_", "geglu"))
    red = trace.reduce_events(raw, spans, owners)
    assert [k["spans"] for k in red["kernels"]] == [(0, 1), (2, 3), (0, 4),
                                                    ()]
    # without owners nothing lands
    assert trace.reduce_events(raw, spans)["attributed"] == 0


def test_idle_share_and_mfu():
    raw, spans = _slice()
    red = trace.reduce_events(raw, spans)
    ctx = {"red": red, "busy_s": red["busy_s"], "slice_s": 1800 / 1e9,
           "flops": 989e12 * 900 / 1e9}
    assert idle_share(ctx) == pytest.approx(50.0)
    assert mfu(ctx) == pytest.approx(50.0)
    assert idle_share({"red": {"kernels": []}, "slice_s": 1.0}) is None
    assert mfu({"slice_s": 1.0, "flops": 0}) is None


def test_roofline_share_hand_case():
    raw, spans = _slice()
    spans[0]["name"] = "geglu"
    spans[0]["attrs"] = {"m": 8192, "d": 320}
    ctx = {"red": trace.reduce_events(raw, spans), "spans": spans}
    # K3 at d 320, M 8192: 24 M d^2 = 20.13 GFLOP -> 0.02035 ms at 989 TF/s
    b = roofline.geglu_bound(8192, 320)
    assert b == pytest.approx(24 * 8192 * 320 ** 2 / 989e12)
    share = roofline_share(ctx, "geglu", ("k_a",),
                           lambda a: roofline.geglu_bound(a["m"], a["d"]))
    assert share == pytest.approx(100 * b / 200e-9)
    # no kernel of that name: nothing to read, not 0
    assert roofline_share(ctx, "geglu", ("nope",), lambda a: 1.0) is None


def test_bounds_hand_worked():
    # K2, 64x64 self-attention B 2 H 8 D 40: exp-bound at 4096^2
    b, t, h, d = 2, 4096, 8, 40
    assert roofline.flash_bound(b, t, t, h, d) == pytest.approx(
        b * h * t * t / 3.9e12)
    # K2, cross-attention to 77 keys B 32 H 8 D 40: bytes-bound
    nb = 2 * (2 * 32 * 4096 * 8 * 40 + 2 * 32 * 77 * 8 * 40)
    assert roofline.flash_bound(32, 4096, 77, 8, 40) == pytest.approx(
        nb / 3.35e12)
    # K3 at d 1280, M 128: bytes-bound (its weights)
    nb = 2 * (2 * 128 * 1280 + 8 * 1280 ** 2 + 8 * 1280 + 4 * 1280 ** 2
              + 1280)
    assert roofline.geglu_bound(128, 1280) == pytest.approx(nb / 3.35e12)


def test_lm_flops_closed_form():
    opt = {"hidden_size": 4096, "ffn_dim": 16384, "num_hidden_layers": 32,
           "vocab_size": 50272}
    per_layer = 2 * (4 * 4096 ** 2 + 2 * 4096 * 16384)
    assert flops.lm_token_flops(opt, 0, False) == pytest.approx(
        32 * per_layer)
    assert flops.lm_token_flops(opt, 100, True) == pytest.approx(
        32 * (per_layer + 4 * 4096 * 100) + 2 * 4096 * 50272)
    # a prompt: its tokens at half its length of context, one head
    assert flops.prefill_flops(opt, 10) == pytest.approx(
        10 * flops.lm_token_flops(opt, 5, False) + 2 * 4096 * 50272)


def test_flop_counter_on_the_reference():
    from gill_tpu_torch.config import MapperConfig
    from gill_tpu_torch.models import mapper as mapper_mod

    from gillbench.reference import gill as rg

    mc = MapperConfig(in_dim=64, out_dim=24, num_input_tokens=8,
                      num_output_tokens=16, mode="gill_mapper")
    p = flops.meta_tree(lambda i: mapper_mod.init(i, mc))
    x = torch.empty((1, 8, 64), device="meta")
    got = flops.counted(lambda: rg.gill_mapper(p, {"heads": 4}, x, x))
    d, f = 512, 2048
    enc = 4 * (8 * (4 * 2 * d * d + 2 * 2 * d * f) + 4 * 8 * 8 * d)
    dec = 4 * (16 * (4 * 2 * d * d + 2 * 2 * d * f) + 4 * 16 * 16 * d
               + 16 * 2 * 2 * d * d + 8 * 2 * 2 * d * d + 4 * 16 * 8 * d)
    want = 8 * 2 * 64 * d + enc + dec + 16 * 2 * d * 24
    assert got == pytest.approx(want)


def test_forbidden_modules_by_whole_name():
    mods = {"gill_tpu_torch": 1, "gill_tpu_torch.api": 1, "jaxtyping": 1,
            "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "gill_tpu.api": 1, "flax": 1,
                 "jaxlib": 1})
    assert harness.forbidden_modules(mods) == ["flax", "gill_tpu.api",
                                               "jax.numpy", "jaxlib"]
