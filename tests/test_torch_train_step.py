"""The port's train step against gill_tpu's (tests/test_train_step.py's tiny
shapes), and the gradient gates that keep every kernel off the
differentiated path.

Parity: the losses and accuracies, `lr_schedule` against optax's, three
train steps against gill_tpu's `make_train_step` (concat False and True;
loss, every metric, grad_norm, lr and the adapters after each step), remat
and the eval step (gradient accumulation and the W8 frozen LM:
test_torch_train_modes.py). The parameters are made with the port's torch init and
handed to gill_tpu as numpy (`tree_to_numpy`); the port takes gill_tpu's
adapters back through `adapters_from_jax`. Each gill_tpu configuration is
compiled and run once, in a module-scoped fixture. Tolerance: rtol 1e-4 /
atol 1e-5, gill_tpu's own test's (tests/test_train_step.py:148-150).

Gates (CPU stand-ins for the card): under grad the dispatcher refuses the
flash kernel where it would otherwise take it, `flash_attention` raises on
an input that needs a gradient, the W8 predicate refuses such an x, and
`opt._linear` takes one product under grad, with `x @ w`'s gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.config import CLIPVisionConfig, GILLConfig, OPTConfig
from gill_tpu.config import TrainConfig as JTrainConfig
from gill_tpu.models.gill import GILLCore as JCore
from gill_tpu.train import losses as jL
from gill_tpu.train import trainer as jtrainer
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models import opt as topt
from gill_tpu_torch.models.gill import GILLCore as TCore
from gill_tpu_torch.nn import core as tnn
from gill_tpu_torch.nn.core import Init, tree_leaves
from gill_tpu_torch.ops import attention as tattn
from gill_tpu_torch.train import losses as tL
from gill_tpu_torch.train import trainer as ttrainer
from gill_tpu_torch.weights import from_jax
from torch_threads import one_intra_op_thread  # noqa: F401

OPT_TINY = dict(vocab_size=64, hidden_size=16, ffn_dim=32, num_layers=2,
                num_heads=2, word_embed_proj_dim=16, max_positions=96)
VIS_TINY = dict(hidden_size=16, intermediate_size=32, num_layers=1,
                num_heads=2, image_size=16, patch_size=8)
NUM_TOKENS = 4
VOCAB_LEN = 64 + 1 + NUM_TOKENS
IMG_START = 65
PAD, BOS = 1, 2
RTOL, ATOL = 1e-4, 1e-5
TC = dict(lr=2e-3, lr_warmup_steps=2, steps_per_epoch=100, grad_clip=1.0)
STEPS = 3


def make_cores():
    kw = dict(n_visual_tokens=2, num_tokens=NUM_TOKENS, num_clip_tokens=6,
              ret_emb_dim=8, gen_emb_dim=12)
    common = dict(vocab_len=VOCAB_LEN, img_start=IMG_START,
                  pad_token_id=PAD, bos_token_id=BOS)
    jc = JCore(cfg=GILLConfig(**kw), opt_cfg=OPTConfig(**OPT_TINY),
               vis_cfg=CLIPVisionConfig(**VIS_TINY), **common)
    tc = TCore(cfg=tcfg.GILLConfig(**kw), opt_cfg=tcfg.OPTConfig(**OPT_TINY),
               vis_cfg=tcfg.CLIPVisionConfig(**VIS_TINY), **common)
    return jc, tc


def make_batch(b=8, t=12, seed=0):
    rng = np.random.RandomState(seed)
    tokens = np.full((b, t), PAD, np.int32)
    lens = []
    for i in range(b):
        n_words = rng.randint(1, t - NUM_TOKENS - 1)
        row = [BOS] + list(rng.randint(4, 60, n_words)) + list(
            range(IMG_START, IMG_START + NUM_TOKENS))
        tokens[i, :len(row)] = row
        lens.append(len(row))
    lens = np.array(lens, np.int32)
    return {"pixels": rng.randn(b, 16, 16, 3).astype(np.float32),
            "ret_tokens": tokens, "ret_len": lens, "gen_tokens": tokens,
            "gen_len": lens,
            "clip_emb": rng.randn(b, 6, 12).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    jc, tc = make_cores()
    params = from_jax.tree_to_numpy(
        tc.init_params(Init(torch.Generator().manual_seed(0), "cpu")))
    frozen_j = {"lm": params["lm"], "vision": params["vision"]}
    frozen_t = {"lm": from_jax.opt_from_jax(params["lm"]),
                "vision": from_jax.clip_vision_from_jax(params["vision"])}
    return {"jc": jc, "tc": tc, "params": params, "frozen_j": frozen_j,
            "frozen_t": frozen_t, "batch": make_batch()}


def _flat(tree):
    """{path: numpy leaf} of a JAX tree or (via tree_to_numpy) the port's."""
    if any(torch.is_tensor(x) for x in tree_leaves(tree)):
        tree = from_jax.tree_to_numpy(tree)
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _metrics_np(m):
    out = {k: np.asarray(v, np.float32) for k, v in m.items() if k != "_viz"}
    out.update({f"_viz/{k}": np.asarray(v) for k, v in m["_viz"].items()})
    return out


def run_jax(s, tcj, frozen, concat_seq, steps=STEPS, step=None):
    """gill_tpu's train step, `steps` times: [(metrics, adapters)]."""
    step = step or jtrainer.make_train_step(s["jc"], tcj)
    state = jtrainer.init_state(s["jc"], tcj, jax.tree_util.tree_map(
        jnp.asarray, s["params"]["adapters"]))
    batch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    out = []
    for i in range(steps):
        state, m = step(state, frozen, batch, concat=concat_seq[i])
        out.append((_metrics_np(jax.device_get(m)), _flat(state.adapters)))
    return out


def run_torch(s, tct, frozen, concat_seq, steps=STEPS):
    step = ttrainer.make_train_step(s["tc"], tct)
    state = ttrainer.init_state(tct, from_jax.adapters_from_jax(
        s["params"]["adapters"]))
    batch = ttrainer.put_batch(s["batch"], "cpu")
    out = []
    for i in range(steps):
        state, m = step(state, frozen, batch, concat=concat_seq[i])
        out.append((_metrics_np(m), _flat(state.adapters)))
    assert state.step == steps
    return out


def _assert_runs_match(got, want):
    for i, ((gm, ga), (wm, wa)) in enumerate(zip(got, want)):
        assert set(gm) == set(wm), (i, sorted(gm), sorted(wm))
        for k in wm:
            if k.startswith("_viz/"):
                np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)
            else:
                np.testing.assert_allclose(gm[k], wm[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"step {i} {k}")
        assert set(ga) == set(wa)
        for k in wa:
            np.testing.assert_allclose(ga[k], wa[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} adapters {k}")


# ---------------------------------------------------------------------------
# losses and the schedule
# ---------------------------------------------------------------------------

def test_losses_and_accuracies_match():
    rng = np.random.RandomState(0)
    u = rng.randn(5, 7, 6).astype(np.float32)
    v = rng.randn(5, 7, 6).astype(np.float32)
    v[0, 0] = u[0, 0]                               # the 1e-12 floor
    np.testing.assert_allclose(
        tL.l2_loss(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        np.asarray(jL.l2_loss(u, v)), rtol=1e-6)
    with pytest.raises(ValueError):
        tL.l2_loss(torch.zeros(2, 3), torch.zeros(3, 2))
    logits = rng.randn(9, 9).astype(np.float32)
    logits[2, 5] = logits[2, 2]                     # a tie at the target
    tlog = torch.from_numpy(logits)
    np.testing.assert_allclose(float(tL.contrastive_loss(tlog)),
                               float(jL.contrastive_loss(logits)), rtol=1e-6)
    for got, want in zip(tL.contrastive_acc(tlog, topk=(1, 3, 5)),
                         jL.contrastive_acc(logits, topk=(1, 3, 5))):
        assert float(got) == pytest.approx(float(want))
    vocab = rng.randn(3, 6, 40).astype(np.float32)
    labels = rng.randint(0, 40, (3, 6)).astype(np.int32)
    labels[0, :3] = -100
    vocab[1, 1, 7] = vocab[1, 1, labels[1, 1]]      # a tie
    for got, want in zip(tL.token_accuracy(torch.from_numpy(vocab),
                                           torch.from_numpy(labels)),
                         jL.token_accuracy(vocab, labels)):
        assert float(got) == pytest.approx(float(want))


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, lr_warmup_steps=10, steps_per_epoch=4,
         lr_schedule_step_size=5, lr_schedule_gamma=0.1),
    dict(lr=3e-4, lr_warmup_steps=0, steps_per_epoch=3,
         lr_schedule_step_size=2, lr_schedule_gamma=0.5),
    dict(lr=2e-3, lr_warmup_steps=7, steps_per_epoch=0)])
def test_lr_schedule_matches_optax(kw):
    want = jtrainer.lr_schedule(JTrainConfig(**kw))
    got = ttrainer.lr_schedule(tcfg.TrainConfig(**kw))
    for step in range(60):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12), step


def test_train_config_matches_gill_tpu():
    assert dataclasses.asdict(tcfg.TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())
    tc = tcfg.TrainConfig(lr=5e-4, remat=True, seed=3)
    assert tcfg.TrainConfig.from_json(tc.to_json()) == tc
    assert JTrainConfig.from_json(tc.to_json()) == JTrainConfig(
        lr=5e-4, remat=True, seed=3)


# ---------------------------------------------------------------------------
# train steps against gill_tpu
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(setup):
    """The gill_tpu runs the parity tests compare with, made once (one
    jitted step, compiled once for each concat value)."""
    s = setup
    step = jtrainer.make_train_step(s["jc"], JTrainConfig(**TC))
    return {"plain": run_jax(s, JTrainConfig(**TC), s["frozen_j"],
                             [False] * STEPS, step=step),
            "concat": run_jax(s, JTrainConfig(**TC), s["frozen_j"],
                              [True, False, True], step=step)}


@pytest.fixture(scope="module")
def torch_plain(setup):
    return run_torch(setup, tcfg.TrainConfig(**TC), setup["frozen_t"],
                     [False] * STEPS)


def test_three_train_steps_match_gill_tpu(runs, torch_plain):
    _assert_runs_match(torch_plain, runs["plain"])
    assert torch_plain[0][0]["lr"] == 0.0          # lr(0) with warmup
    moved = max(np.abs(torch_plain[-1][1][k] - torch_plain[0][1][k]).max()
                for k in torch_plain[0][1])
    assert moved > 0


def test_three_concat_train_steps_match_gill_tpu(setup, runs):
    got = run_torch(setup, tcfg.TrainConfig(**TC), setup["frozen_t"],
                    [True, False, True])
    _assert_runs_match(got, runs["concat"])


def test_remat_steps_equal_plain_steps(setup, runs, torch_plain):
    """Two steps (the second applies an update) with each LM layer under
    torch.utils.checkpoint: bit for bit the plain steps."""
    tct = tcfg.TrainConfig(**TC, remat=True)
    got = run_torch(setup, tct, setup["frozen_t"], [False, False], steps=2)
    for (gm, ga), (pm, pa) in zip(got, torch_plain):
        for k in pm:
            np.testing.assert_array_equal(gm[k], pm[k], err_msg=k)
        for k in pa:
            np.testing.assert_array_equal(ga[k], pa[k], err_msg=k)
    _assert_runs_match(got, runs["plain"])


def test_eval_step_matches_gill_tpu(setup, runs):
    """gill_tpu's first train step reports the losses of the starting
    adapters, which is what the eval step computes (no prefix here; the
    prefix's forward is held to gill_tpu in test_torch_gill_forward.py)."""
    s = setup
    adapters = from_jax.adapters_from_jax(s["params"]["adapters"])
    got = _metrics_np(ttrainer.make_eval_step(s["tc"], tcfg.TrainConfig(**TC))(
        adapters, s["frozen_t"], ttrainer.put_batch(s["batch"], "cpu")))
    want = runs["plain"][0][0]
    assert set(want) - set(got) == {"grad_norm", "lr", "img_emb_norm"}
    for k in got:
        if k.startswith("_viz/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert not any(x.requires_grad for x in tree_leaves(adapters))


def test_step_refuses_frozen_trees_that_require_grad(setup):
    s = setup
    tct = tcfg.TrainConfig(**TC)
    frozen = {"lm": s["frozen_t"]["lm"],
              "vision": tnn.tree_map(lambda x: x.clone().requires_grad_(True),
                                     s["frozen_t"]["vision"])}
    state = ttrainer.init_state(tct, from_jax.adapters_from_jax(
        s["params"]["adapters"]))
    with pytest.raises(ValueError, match="frozen"):
        ttrainer.make_train_step(s["tc"], tct)(
            state, frozen, ttrainer.put_batch(s["batch"], "cpu"))


# ---------------------------------------------------------------------------
# gradient gates
# ---------------------------------------------------------------------------

def _qkv(t=6, s=6, requires_grad=True):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 2, 8, generator=g) for n in (t, s, s))
    return [x.requires_grad_(requires_grad) for x in (q, k, v)]


def test_flash_eligible_refuses_inputs_that_need_grad():
    kw = dict(on_cuda=True, t=39, s=39, has_bias=False, has_kv_offset=False,
              impl="auto", causal=True)
    assert tattn.flash_eligible(**kw)
    assert not tattn.flash_eligible(**kw, grad=True)
    assert not tattn.flash_eligible(**{**kw, "impl": "flash"}, grad=True)
    assert tattn.flash_eligible(**{**kw, "causal": False, "s": 257})
    assert not tattn.flash_eligible(**{**kw, "causal": False, "s": 257},
                                    grad=True)


def test_dispatcher_takes_the_plain_path_under_grad(monkeypatch):
    """With the card's rule in force (on_cuda=True), a causal call whose
    inputs need a gradient goes to _xla_attention; the same call under
    no_grad would take the kernel."""
    calls = []
    orig = tattn.flash_eligible

    def on_card(**kw):
        return orig(**{**kw, "on_cuda": True})

    def kernel(q, k, v, **kw):
        calls.append(q.shape)
        return tattn.flash_attention_ref(q, k, v, causal=kw["causal"],
                                         scale=kw["scale"])

    monkeypatch.setattr(tattn, "flash_eligible", on_card)
    monkeypatch.setattr(tattn, "flash_attention", kernel)
    q, k, v = _qkv()
    out = tattn.dot_product_attention(q, k, v, causal=True)
    assert calls == []
    want = tattn._xla_attention(q, k, v, causal=True, scale=8 ** -0.5)
    assert torch.equal(out, want)
    out.sum().backward()
    assert q.grad is not None and float(q.grad.abs().sum()) > 0
    with torch.no_grad():
        tattn.dot_product_attention(q, k, v, causal=True)
    assert len(calls) == 1


def test_flash_attention_raises_on_inputs_that_need_grad():
    q, k, v = _qkv()
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v, causal=True)
    ref = tattn.flash_attention_ref(q, k, v, causal=True)
    assert ref.requires_grad
    torch.testing.assert_close(out, ref.detach())
    ref.sum().backward()
    assert k.grad is not None


def test_decode_gate_refuses_inputs_that_need_grad():
    q = torch.randn(2, 1, 2, 128, dtype=torch.bfloat16)
    k = torch.randn(2, 64, 2, 128, dtype=torch.bfloat16)
    k1 = torch.randn(2, 1, 2, 128, dtype=torch.bfloat16)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    args = (q, k, lens, (k1, k1), None)
    assert tattn.prefix_decode_eligible(*args, on_cuda=True)
    q.requires_grad_(True)
    assert not tattn.prefix_decode_eligible(*args, on_cuda=True)
    with torch.no_grad():
        assert tattn.prefix_decode_eligible(*args, on_cuda=True)


def test_w8_predicate_refuses_x_that_needs_grad():
    w = torch.randn(512, 1024)
    p = {k: v[0] for k, v in topt.quantize_params_w8(
        {"layers": {"attn": {c: {"w": w[None]} for c in "qkvo"},
                    "fc1": {"w": w[None]}, "fc2": {"w": w[None]}}},
        kernel=True)["layers"]["fc1"].items() if k != "kern"}
    x = torch.randn(39, 512, dtype=torch.bfloat16)
    assert tnn.w8_kernel_eligible(p, x, on_cuda=True)
    assert not tnn.w8_kernel_eligible(p, x, on_cuda=False)
    xg = x.clone().requires_grad_(True)
    assert not tnn.w8_kernel_eligible(p, xg, on_cuda=True)
    with torch.no_grad():
        assert tnn.w8_kernel_eligible(p, xg, on_cuda=True)
    # on the CPU the dequant form carries the gradient to x
    y = tnn.linear(p, xg.float())
    y.sum().backward()
    assert xg.grad is not None and xg.grad.shape == x.shape


def test_opt_linear_takes_one_product_under_grad(monkeypatch):
    """On the card (on_cuda=True) a 330-row product without gradients
    takes the 128-row windows; one that needs a gradient takes one
    product, whose gradients are x @ w's; the window branch, forced on
    the CPU, gives the same output."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 24, generator=g)
    b = torch.randn(24, generator=g)
    x = torch.randn(3, 110, 16, generator=g)          # 330 rows, 3 windows
    p = {"w": w, "b": b}
    assert topt.use_row_windows(p, x, on_cuda=True)
    assert not topt.use_row_windows(p, x, on_cuda=False)
    assert not topt.use_row_windows(p, x[:, :40], on_cuda=True)
    xg = x.clone().requires_grad_(True)
    assert not topt.use_row_windows(p, xg, on_cuda=True)
    wg = {"w": w.clone().requires_grad_(True), "b": b}
    assert not topt.use_row_windows(wg, x, on_cuda=True)
    with torch.no_grad():
        assert topt.use_row_windows(p, xg, on_cuda=True)

    monkeypatch.setattr(topt, "use_row_windows", lambda p, x, on_cuda: True)
    y_win = topt._linear(p, x)
    monkeypatch.undo()
    y1 = topt._linear(wg, xg)
    x2 = x.clone().requires_grad_(True)
    w2 = w.clone().requires_grad_(True)
    y2 = x2 @ w2 + b
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y_win, y2.detach())
    dy = torch.randn(y1.shape, generator=g)
    (y1 * dy).sum().backward()
    (y2 * dy).sum().backward()
    assert torch.equal(xg.grad, x2.grad)
    assert torch.equal(wg["w"].grad, w2.grad)
