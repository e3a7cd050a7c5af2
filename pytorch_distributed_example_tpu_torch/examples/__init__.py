"""Entry points of the port: `python -m pytorch_distributed_example_tpu_torch.examples.<name>`."""
