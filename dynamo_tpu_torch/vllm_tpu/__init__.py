"""vLLM-profile worker of the port: python -m dynamo_tpu_torch.vllm_tpu."""
