"""The plain PyTorch reference that decides `correct`.

Plain fp32 copies of GILL's forward passes (OPT, CLIP ViT, the GILL mappers,
the SD v1.5 UNet, PNDM and the VAE decoder) over parameter trees in the
port's layout, which the benchmark makes from the seed. No kernel, cache or
batching; TF32 off (`fp32_matmul`); under `layers.rounded(dtype)` the same
at a lower precision, the control. Nothing here imports the port, gill_tpu
or JAX: where the port derived something from the seeded inputs (the
[IMG]-merged embedding table, SD's first latents), this package works it
out again.
"""
