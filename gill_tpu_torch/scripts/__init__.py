"""The probe scripts of scripts/ as torch entry points on the card.

Each runs as `python -m gill_tpu_torch.scripts.<name>` on a CUDA device
(it prints the card's name and power limit first) and writes no file
unless given `--out PATH`. Its measuring function takes the shape list
(the original script's shapes by default) and `device`; with
device="cpu" it runs the plain versions of the kernels at whatever small
shapes it is given, which is how the tests run it.
"""
