"""resilience/ — durable file primitives (counterpart of
``deepspeed_tpu/resilience``; only ``atomic.py`` is ported: the session
spill of the paged KV pool uses it, and checkpoints will)."""
