"""gill_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of gill_tpu.

The JAX package `gill_tpu` stays the reference; this package computes the
same functions with PyTorch on tensors that carry an explicit device, and
imports nothing of JAX or of gill_tpu. Layouts follow gill_tpu at every
public function (linear weights (in, out), activations NHWC, attention
q/k/v (B, T, H, D)) so a reader finds each module's counterpart under the
same path:

  config.py, tokenizer.py, utils/{image,ckpt}.py   <- their gill_tpu namesakes
  nn/core.py            <- gill_tpu/nn/core.py
  ops/attention.py      <- gill_tpu/ops/attention.py   (CUDA flash kernel)
  ops/geglu.py          <- gill_tpu/ops/geglu.py       (CUDA GEGLU kernel)
  ops/sampling.py, models/{clip,opt,mapper,decision,gill}.py,
  models/sd/{scheduler,unet,vae,pipeline}.py, retrieval.py, api.py,
  train/{losses,trainer,validate,bleu}.py, data/dataset.py,
  utils/{tb,meters}.py  <- their gill_tpu namesakes
  main.py               <- the repository's main.py (the training CLI)
  weights/from_jax.py   gill_tpu param tree -> this package's param tree

Hand-written CUDA kernels live in csrc/ and are compiled with nvcc at first
use (ops/_build.py). Importing this package needs neither a GPU, nvcc nor
JAX.
"""

__version__ = "0.1.0"
