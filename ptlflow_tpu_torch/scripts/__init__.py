"""Entry points of the PyTorch port: ``python -m ptlflow_tpu_torch.scripts.<name>``
for validate, infer, test and model_benchmark."""
