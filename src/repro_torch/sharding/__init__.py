"""The logical-axis sharding rules and the ambient activation layout: the
port of ``repro/sharding``."""
from repro_torch.sharding.context import activation_sharding, shard_act
from repro_torch.sharding.spec import (PSpec, Rules, cache_pspecs,
                                       logical_to_pspec, make_rules,
                                       param_pspecs, placements)

__all__ = ["PSpec", "Rules", "activation_sharding", "cache_pspecs",
           "logical_to_pspec", "make_rules", "param_pspecs", "placements",
           "shard_act"]
