"""Frontend/router process package (`python -m dynamo_tpu_torch.frontend`)."""
