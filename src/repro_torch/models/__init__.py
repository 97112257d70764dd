"""Model assembly of the port."""
from repro_torch.models.model import (build_pattern, cache_init, cache_insert,
                                      decode_step, forward, model_init,
                                      paged_cache_init, prefill,
                                      prefill_chunk_step, prefill_into_slot,
                                      router_init, router_param_count)

__all__ = ["build_pattern", "cache_init", "cache_insert", "decode_step",
           "forward", "model_init", "paged_cache_init", "prefill",
           "prefill_chunk_step", "prefill_into_slot", "router_init",
           "router_param_count"]
