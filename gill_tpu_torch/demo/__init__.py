"""The chat demo of demo/ on the port (`python -m
gill_tpu_torch.demo.app_gradio`)."""
