"""Multi-LoRA adapter serving.

`apply` holds the batched in-engine LoRA math (stacked `[L, slots, in, R]`
device tensors, per-row slot indices); `registry` holds the host-resident
adapter store with bounded device slots and LRU load/unload. The port's
own copy of `dynamo_tpu/lora` (it imports nothing of the JAX package).
"""
