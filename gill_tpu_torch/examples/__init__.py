"""The inference examples of examples/ on the port (`python -m
gill_tpu_torch.examples.inference_examples`)."""
