"""The evaluation protocol of evals/ as torch entry points: VIST and
VisDial generation, CLIP similarity and LPIPS, each run as
`python -m gill_tpu_torch.evals.<name>` on the card unless `--device cpu`
is given."""
