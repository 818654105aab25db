"""Personalized inference data plane (port of ``repro/serve``; DESIGN.md
§15–16): route requests to each device's preferred model, batch
same-model requests into one decode dispatch, pool KV caches per live
model — with speculative decoding against cluster-shared drafts, paged
int8 KV storage, and admission control."""
from repro_torch.serve.batcher import ModelGroup, Request
from repro_torch.serve.draft import (DraftBank, draft_config, draft_depth,
                                     truncate_lm_params)
from repro_torch.serve.gateway import (OverloadError, RequestRejected,
                                       RoutingTable, ServeGateway)
from repro_torch.serve.kv_pool import (KVPool, KVPoolManager, PageArena,
                                       PagedKVPool)

__all__ = ["ModelGroup", "Request", "RequestRejected", "OverloadError",
           "RoutingTable", "ServeGateway", "KVPool", "KVPoolManager",
           "PageArena", "PagedKVPool", "DraftBank", "draft_config",
           "draft_depth", "truncate_lm_params"]
