"""S1: the plain version of the repeated-product probe (gill_tpu_torch/ops/
mm_probe.py) against scripts/attn_mxu_probe.py's Pallas kernel `mk`, run
in interpret mode on the CPU (nothing in scripts/ changes: the test swaps
`pallas_call` for its interpret form while it runs).

Tolerances: int8 exactly equal (int32 sums of integers); bf16 within 1e-5
of the largest |output|, relative (both sides sum exact products of bf16
values in fp32, in another order, then add the product REPS times).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gill_tpu_torch.ops import mm_probe as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name: str):
    """scripts/<name>.py as a module, by file path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def mxu(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return load_script("attn_mxu_probe")


def _operands(m, k, n, dtype, seed):
    """The script's data (normal * 3 cast to the operand dtype), made with
    numpy and handed to both sides."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32) * 3
    b = rng.standard_normal((k, n)).astype(np.float32) * 3
    if dtype == "int8":
        a, b = a.astype(np.int8), b.astype(np.int8)
        return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a),
                                                  torch.from_numpy(b))
    return ((jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)),
            (torch.from_numpy(a).to(torch.bfloat16),
             torch.from_numpy(b).to(torch.bfloat16)))


@pytest.mark.parametrize("m,k,n,dtype", [
    (40, 64, 128, "bfloat16"), (48, 96, 64, "bfloat16"),
    (64, 128, 256, "bfloat16"), (40, 64, 128, "int8"),
    (64, 128, 256, "int8")])
def test_plain_matches_pallas_kernel(mxu, m, k, n, dtype):
    (ja, jb), (ta, tb) = _operands(m, k, n, dtype, seed=m + k + n)
    if dtype == "int8":
        want = np.asarray(mxu.mk(m, k, n, jnp.int8, jnp.int32)(ja, jb))
        got = mp.mm_probe(ta, tb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = np.asarray(mxu.mk(m, k, n, jnp.bfloat16, jnp.float32)(ja, jb))
        got = mp.mm_probe(ta, tb)
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_int8_sums_fit_int32_at_the_probe_shape_and_raise_past_it():
    """C8's worst sum, 32 * 4096 * 127^2 ~ 2.11e9, fits int32; 32 * 4176
    * 127^2 ~ 2.16e9 does not, and the plain version says so."""
    a = torch.full((1, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 1), 127, dtype=torch.int8)
    assert int(mp.mm_probe_ref(a, b)) == mp.REPS * 4096 * 127 ** 2
    a, b = torch.full((1, 4176), 127, dtype=torch.int8), \
        torch.full((4176, 1), 127, dtype=torch.int8)
    with pytest.raises(OverflowError):
        mp.mm_probe_ref(a, b)


def test_wrapper_refuses_what_it_does_not_take():
    a = torch.zeros(4, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        mp.mm_probe(a, torch.zeros(16, 8, dtype=torch.int8))
    with pytest.raises(ValueError):
        mp.mm_probe(a, torch.zeros(8, 8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        mp.mm_probe(a.float(), torch.zeros(16, 8))
