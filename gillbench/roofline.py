"""The yardstick: published H100 peaks and the least time a kernel could take.

A frozen copy of the port's `scripts/_timing.py` `bound` arithmetic and peaks
(NVIDIA H100 SXM data sheet, dense rates), kept here so that a change to the
port cannot move it. Each kernel's operations and bytes are worked out from
the shapes the benchmark's wrappers record: each input byte read once, each
output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
# exponentials a second on the special-function units (FlashAttention-3,
# Shah et al. 2024: 16 a clock on each of 132 SMs at 1.83 GHz)
EXP_S = 3.9e12
BF16 = 2


def bound_s(nbytes: float, flops: float, kind: str = "bf16",
            exps: float = 0.0) -> float:
    """The least seconds the card could take: the largest of the bytes over
    the memory rate, the operations over their peak and the exponentials
    over the special-function rate (the three run concurrently)."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[kind], exps / EXP_S)


def flash_bound(b, t, s, h, d, causal=False) -> float:
    """Attention softmax(q k^T) v, bf16: q, k, v read once, o written once."""
    pairs = b * h * t * s * (0.5 if causal and t == s else 1.0)
    nbytes = BF16 * (2 * b * t * h * d + 2 * b * s * h * d)
    return bound_s(nbytes, 4.0 * pairs * d, "bf16", exps=pairs)


def geglu_bound(m, d) -> float:
    """GEGLU feed-forward (m, d) -> (m, 8d) -> (m, 4d) -> (m, d), bf16."""
    flops = 2.0 * m * d * 8 * d + 2.0 * m * 4 * d * d
    nbytes = BF16 * (2 * m * d + 8 * d * d + 8 * d + 4 * d * d + d)
    return bound_s(nbytes, flops, "bf16")


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
