"""TRT-LLM-profile worker of the port: python -m dynamo_tpu_torch.trtllm_tpu."""
