from dynamo_tpu_torch.serving.worker import main

if __name__ == "__main__":
    main(backend_name="trtllm_tpu")
