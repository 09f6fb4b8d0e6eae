"""Sharding of the port's LM parameters over a ``data`` x ``model`` grid of
``torch.distributed`` ranks (the reference's ``repro.sharding``):

    rules   the reference's divisibility-aware PartitionSpec policy, leaf by
            leaf over the port's parameters, optimizer state, batch and cache;
    steps   its consumer: the process grid, the placement of each rank's
            slices and a spec-placed FSDP/TP train step;
    serve   sharded prefill and decode: the cache placed by ``cache_pspecs``,
            each layer's parameters gathered on use.
"""

from . import serve
from .rules import (P, batch_pspecs, cache_pspecs, data_axes, opt_state_pspecs,
                    param_pspecs, param_shapes, token_pspec)

__all__ = ["P", "batch_pspecs", "cache_pspecs", "data_axes", "opt_state_pspecs",
           "param_pspecs", "param_shapes", "serve", "token_pspec"]
