"""The scripts of scripts/ as torch entry points, `python -m
gill_tpu_torch.scripts.<name>`.

The probes (attn_mxu_probe, attn_sweep, int8_probe, profile_*, w8_probe)
run on a CUDA device (each prints the card's name and power limit first)
and write no file unless given `--out PATH`. Each measuring function
takes the shape list (the original script's shapes by default) and
`device`; with device="cpu" it runs the plain versions of the kernels at
whatever small shapes it is given, which is how the tests run it.

The data and decision scripts (extract_img_embs, preprocess_sd_embeddings,
generate_sd_p2_images, train_decision_classifier, process_p2_annotations,
prune_model_ckpt) and validate_real_weights keep their originals' flags,
files and formats; those that run a model take `--device` (the card
unless `--device cpu`).
"""
