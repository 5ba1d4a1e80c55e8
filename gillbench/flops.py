"""Model FLOPs of the work a slice did, counted from shapes: the whole
step's share of the chip's peak (`mfu.*`).

The UNet, VAE, CLIP and mapper counts come from running the plain reference
on meta tensors under torch's FlopCounterMode (matrix products and
convolutions only; no data, no device), once a set-up. The LM's count is
the usual closed form: 2 x the layer parameters a token, the causal
attention's 4 x d x context a token and layer, the tied head's 2 x d x V a
token whose logits are taken.
"""

from __future__ import annotations

import torch

from gillbench.roofline import PEAK_FLOPS

PEAK_BF16 = PEAK_FLOPS["bf16"]


def counted(fn, *args) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn(*args)
    return float(fc.get_total_flops())


def meta_tree(build):
    """A parameter tree of meta tensors in the port's layout."""
    from gillbench.weights import SeededInit, _Plan

    return build(SeededInit("meta", torch.float32, _Plan()))


def _opt_layer_params(d: int, f: int) -> int:
    return 4 * d * d + 2 * d * f


def lm_token_flops(opt: dict, context: float, head: bool) -> float:
    """One token through OPT at a mean attended context."""
    d, f, n = opt["hidden_size"], opt["ffn_dim"], opt["num_hidden_layers"]
    fl = n * (2.0 * _opt_layer_params(d, f) + 4.0 * d * context)
    if head:
        fl += 2.0 * d * opt["vocab_size"]
    return fl


def prefill_flops(opt: dict, length: int) -> float:
    """A causal prompt of `length` tokens (mean context length / 2), its
    last position's head."""
    return length * lm_token_flops(opt, length / 2.0, False) \
        + lm_token_flops(opt, 0, True) - lm_token_flops(opt, 0, False)
