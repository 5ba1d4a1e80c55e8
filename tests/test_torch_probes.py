"""The ported probe scripts (gill_tpu_torch/scripts/) on the CPU at tiny
shapes, where they run the kernels' plain versions: each prints the
original script's rows (the same names, columns and JSON keys, with
`xla_us` / `pallas_us` renamed to what runs), the UNet ablation restores
the module after an exception, and nothing is written without --out.
"""

import contextlib
import glob
import io
import json
import os

import pytest

from gill_tpu_torch.config import OPTConfig, tiny_unet_config
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.scripts import (attn_mxu_probe, attn_sweep, int8_probe,
                                    profile_ln_fuse, profile_prefix_decode,
                                    profile_sd, profile_sd_ablate,
                                    profile_specdec, w8_probe)
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_unet_config()

# each probe's measuring function at tiny shapes on the CPU
TINY = {
    "attn_mxu_probe": (attn_mxu_probe, dict(
        cases=[("A QK bf16 (512,128)x(128,2048)", 40, 32, 64, "bfloat16"),
               ("B QK int8", 40, 32, 64, "int8")], n1=1, n2=2)),
    "attn_sweep": (attn_sweep, dict(shape=(1, 256, 2, 40), n1=1, n2=2)),
    "int8_probe": (int8_probe, dict(mm_shapes=[(64, 32, 48)],
                                    conv_shapes=[(1, 8, 16, 16)], n1=1,
                                    n2=2)),
    "profile_sd": (profile_sd, dict(resolutions=[(8, 32, 1), (4, 64, 1)],
                                    cfg=CFG, batch=2, n1=1, n2=2,
                                    unet_reps=1)),
    "profile_sd_ablate": (profile_sd_ablate, dict(cfg=CFG, batch=2, hw=8,
                                                  reps=1)),
    "profile_ln_fuse": (profile_ln_fuse, dict(resolutions=[(8, 32, 1)],
                                              cfg=CFG, batch=2, n1=1, n2=2,
                                              unet_reps=1)),
    "profile_prefix_decode": (profile_prefix_decode, dict(
        configs=[("tiny", 4, 64, 2, 128)], n_lo=1, n_hi=2)),
    "w8_probe": (w8_probe, dict(shapes=[(512, 512), (512, 1024)], reps=2)),
    "profile_specdec": (profile_specdec, dict(
        target=OPTConfig(num_layers=2, hidden_size=64, ffn_dim=128,
                         num_heads=4, vocab_size=128, max_positions=512,
                         word_embed_proj_dim=64),
        draft=OPTConfig(num_layers=1, hidden_size=32, ffn_dim=64,
                        num_heads=2, vocab_size=64, max_positions=512,
                        word_embed_proj_dim=32),
        k=4, plen=8, rounds=(1, 2), steps=(2, 4))),
}


def _records():
    return {p: os.path.getmtime(p)
            for p in glob.glob(os.path.join(REPO, "*_PROBE.json"))}


def _main(name, argv, cwd):
    """`name`'s main(argv) in the working directory `cwd`: (exit code,
    printed lines, the directory's listing after)."""
    mod, kw = TINY[name]
    here, buf = os.getcwd(), io.StringIO()
    os.makedirs(cwd)
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(argv), device="cpu", **kw)
    finally:
        os.chdir(here)
    return rc, buf.getvalue().splitlines(), sorted(os.listdir(cwd))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each probe run as a user runs it, once without --out and once with
    it, each in an empty working directory (at the first test that asks
    for it): {"rc", "lines", "listing", "out_rc", "out_listing", "rows",
    "records_kept"}. The row tests read the first run's lines."""
    done = {}

    def run(name):
        if name not in done:
            d = tmp_path_factory.mktemp(name)
            before = _records()
            rc, lines, listing = _main(name, [], str(d / "plain"))
            out = d / "out" / "rows.json"
            out_rc, _, out_listing = _main(name, ["--out", str(out)],
                                           str(d / "out"))
            done[name] = {"rc": rc, "lines": lines, "listing": listing,
                          "out_rc": out_rc, "out_listing": out_listing,
                          "rows": json.loads(out.read_text())
                          if out.exists() else None,
                          "records_kept": _records() == before}
        return done[name]
    return run


def _run(name, runs):
    r = runs(name)
    return r["rc"], r["lines"]


def test_attn_mxu_probe_rows(runs):
    rc, lines = _run("attn_mxu_probe", runs)
    assert rc == 0
    assert lines[0].startswith("# device: cpu")
    for line, name in zip(lines[1:], ("A QK bf16 (512,128)x(128,2048)",
                                      "B QK int8")):
        assert line.startswith(name) and "us/mm" in line and "T/s" in line
        assert "of peak" in line and "library" in line


def test_attn_sweep_rows_follow_the_original(runs):
    rc, lines = _run("attn_sweep", runs)
    assert rc == 0
    names = ["current(auto 256xS)", "single-pass bq=256", "single-pass bq=512",
             "single-pass bq=1024", "bq=512 online bk=1024",
             "bq=256 bf16-probs", "bq=512 bf16-probs", "bq=512 k-transposed",
             "bq=512 nomax", "bq=1024 nomax"]
    rows = lines[1:]
    assert [r[:28].rstrip() for r in rows] == names
    for r in rows:
        assert " ms   maxerr=" in r and "tile " in r
        # every variant computes the same attention within a few bf16 ulps
        assert float(r.split("maxerr=")[1].split()[0]) < 1e-2


def test_int8_probe_rows(runs):
    rc, lines = _run("int8_probe", runs)
    assert rc == 0
    assert lines[1].startswith("mm 64x32x48: bf16 ")
    assert "TF/s" in lines[1] and "TOP/s" in lines[1]
    assert "int8+deq" in lines[1]
    assert lines[2].startswith("conv 1x8^2x16->16: bf16 ")
    assert "TOP/s" in lines[2] and "FAILED" not in lines[2]


def test_profile_sd_rows(runs):
    rc, lines = _run("profile_sd", runs)
    assert rc == 0
    assert lines[1].split() == ["component", "ms", "ms*layers"]
    for part in ("8x8/32 self-attn(S=64)", "8x8/32 cross-attn",
                 "8x8/32 geglu-ff", "8x8/32 spatial_tfm total",
                 "8x8/32 resnet", "4x4/64 self-attn(S=16)"):
        assert any(ln.startswith(part) for ln in lines), part
    assert any(ln.startswith("FULL UNET step (CFG batch 2) host")
               for ln in lines)
    assert any("device-busy" in ln and "not measured" in ln for ln in lines)
    assert any(ln.startswith("accounted tfm+res (approx)") for ln in lines)
    assert not any("chip" in ln for ln in lines)


def test_profile_sd_ablate_rows(runs):
    orig = (unet_mod._tfm_block, unet_mod._spatial_tfm, unet_mod._resnet)
    rc, lines = _run("profile_sd_ablate", runs)
    assert rc == 0
    assert [ln[:24].rstrip() for ln in lines[1:]] == [
        "baseline", "w/o self-attn", "w/o cross-attn", "w/o geglu-ff",
        "w/o all-attn+ff", "w/o spatial-tfm (all)", "w/o resnet bodies"]
    assert all(" ms host" in ln for ln in lines[1:])
    assert (unet_mod._tfm_block, unet_mod._spatial_tfm,
            unet_mod._resnet) == orig


def test_profile_sd_ablate_restores_the_module_after_an_exception(
        monkeypatch):
    """The first ablation's run raises: `_tfm_block` is the original
    afterwards all the same."""
    orig = unet_mod._tfm_block
    calls = []

    def flaky(fn, device, reps=3):
        calls.append(unet_mod._tfm_block is orig)
        if len(calls) == 2:
            raise RuntimeError("a failing run")
        return 1.0, None

    monkeypatch.setattr(profile_sd_ablate, "host_and_device_ms", flaky)
    with pytest.raises(RuntimeError, match="a failing run"):
        profile_sd_ablate.ablate(cfg=CFG, batch=2, hw=8, device="cpu")
    assert calls == [True, False]          # the second run was patched
    assert unet_mod._tfm_block is orig


def test_profile_ln_fuse_rows_and_restores_fuse_ln(runs):
    saved = unet_mod.FUSE_LN
    rc, lines = _run("profile_ln_fuse", runs)
    assert rc == 0 and unet_mod.FUSE_LN == saved
    row = lines[1]
    assert row.startswith("8x8/32: fused ") and " plain " in row
    assert "saved*1" in row and "max|d|=" in row and "(ref max " in row
    # fused and composed blocks agree within bf16 rounding of the residual
    assert float(row.split("max|d|=")[1].split()[0]) <= 0.05
    assert lines[2].startswith("FULL UNET step (fused): ")
    assert lines[3].startswith("FULL UNET step (plain): ")


def test_profile_prefix_decode_json_lines(runs):
    rc, lines = _run("profile_prefix_decode", runs)
    assert rc == 0
    recs = [json.loads(ln) for ln in lines[1:]]
    assert [r["mix"] for r in recs] == ["full", "mixed", "halfpark"]
    for r in recs:
        assert list(r) == ["config", "mix", "plain_us", "kernel_us",
                           "speedup"]


def test_w8_probe_rows_follow_the_original(runs):
    """The original's header and rows: the bf16 reference (2x bytes), then
    the kernel at every (block_n, block_k) `w8_plan` accepts at M = 8 (K
    512 takes stages of 128 and 256 rows), each with ms and GB/s."""
    rc, lines = _run("w8_probe", runs)
    assert rc == 0
    assert lines[0].startswith("# device: cpu")
    assert lines[1].split() == ["shape", "config", "ms", "GB/s"]
    rows = [ln for ln in lines[2:] if ln.strip()]
    configs = ["bf16 matmul (2x bytes)", "K4 bn=64 bk=128", "K4 bn=64 bk=256",
               "K4 bn=128 bk=128", "K4 bn=128 bk=256"]
    assert [r.split()[0] for r in rows] == ["512x512"] * 5 + ["512x1024"] * 5
    assert [" ".join(r.split()[1:-2]) for r in rows] == configs * 2
    for r in rows:
        ms, gbs = (float(v) for v in r.split()[-2:])
        assert ms > 0 and gbs >= 0


def test_profile_specdec_rows_follow_the_original(runs):
    """The original's lines (round ms, plain step ms, the acceptance table,
    the breakeven rate) from the port's round mechanics: k draft steps and
    one verify a round, on a W8 target and a draft of another width."""
    rc, lines = _run("profile_specdec", runs)
    assert rc == 0
    assert lines[0].startswith("# device: cpu")
    assert lines[1].startswith("spec round (K=4, custom W8 + custom draft): ")
    assert lines[2].startswith("plain decode step (batch 1): ")
    assert lines[4] == "acceptance -> tokens/s (spec) vs plain:"
    table = lines[5:5 + len(profile_specdec.ACCEPTANCE)]
    assert [ln.split(":")[0].strip() for ln in table] == \
        [f"a={a:.1f}" for a in profile_specdec.ACCEPTANCE]
    a = float(lines[-1].split("a = ")[1])
    assert lines[-1].startswith("breakeven acceptance: ") and 0 <= a <= 1
    # E[tokens/round] at a = 0 is the correction alone, at a -> 1 k tokens
    assert profile_specdec.tokens_per_round(0.0, 4) == 1.0
    assert profile_specdec.tokens_per_round(1.0, 4) == 4.0
    assert profile_specdec.breakeven(4.0, 1.0, 4) == 1.0   # never pays
    assert profile_specdec.breakeven(1.0, 1.0, 4) < 1e-9   # always pays


@pytest.mark.parametrize("name", sorted(TINY))
def test_probe_writes_nothing_without_out(name, runs):
    """No file appears in the working directory, and the TPU records at the
    repository's root are left as they were; --out writes the rows."""
    r = runs(name)
    assert r["rc"] == 0 and r["listing"] == []
    assert r["out_rc"] == 0 and r["out_listing"] == ["rows.json"]
    assert isinstance(r["rows"], list)
    assert r["records_kept"]
