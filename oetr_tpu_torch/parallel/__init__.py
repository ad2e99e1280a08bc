"""Parallelism over ranks (port of ``oetr_tpu/parallel``): meshes and
placements, the model's TP/FSDP/DDP layout, several processes, ring and
Ulysses attention, GPipe; NCCL on the card, gloo on the CPU."""
from .data import global_batch
from .mesh import (OETR_PARTITION_RULES, data_sharding, make_mesh,
                   param_shardings, replicated, shard_batch, shard_model)
from .multihost import (initialize_distributed, make_global_mesh,
                        shard_batch_global, spawn)
from .pipeline import gpipe, pipelined_encoder, stack_encoder_stages
from .ring_attention import (current_ring_context, ring_attention,
                             ring_context, ulysses_attention)

__all__ = ["OETR_PARTITION_RULES", "data_sharding", "make_mesh",
           "param_shardings", "replicated", "shard_batch", "ring_attention",
           "ring_context", "current_ring_context", "ulysses_attention",
           "initialize_distributed", "make_global_mesh",
           "shard_batch_global", "gpipe", "pipelined_encoder",
           "stack_encoder_stages", "shard_model", "global_batch", "spawn"]
