"""Elastic scaling: resume a checkpoint at another rank count, the port of
``repro/runtime/elastic.py``.

A checkpoint holds mesh-independent host arrays: over a mesh, every rank
gathers each leaf whole (``sharding.place.full_tree``) and rank 0 writes
them (``checkpoint.CheckpointManager``). So elasticity is (1) a mesh for
the ranks there are now, (2) the layouts derived anew from the same
logical rules, (3) the restored state placed by them. The global batch
does not depend on the data-parallel width: the step-keyed loader gives
every rank the same global batch and the step keeps each rank's rows.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.sharding.spec import make_rules
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.elastic")


def best_mesh_shape(n_devices: int, prefer_model: int) -> Tuple[int, int]:
    """(data, model) with model | n_devices, model ≤ prefer_model, maximal."""
    model = min(prefer_model, n_devices)
    while n_devices % model != 0:
        model -= 1
    return n_devices // model, model


def make_elastic_mesh(prefer_model: int = 16):
    """A (data, model) mesh over every rank of the default group, shaped by
    ``best_mesh_shape``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(*best_mesh_shape(dist.get_world_size(),
                                           prefer_model))


def reshard_state(model, plan, mesh, state):
    """The train state ``state`` (full tensors, the same on every rank:
    one just restored from a checkpoint) laid out on ``mesh`` by the plan's
    rules, the model's parameters replaced by their DTensors. The rules
    are the reference's here: no divisibility fallback (no axis sizes).
    Returns (the placed state, the rules), for ``make_train_step(...,
    rules=)``."""
    from repro_torch.train.steps import shard_train_state
    rules = make_rules(fsdp=plan.fsdp, tp=plan.tp, sp=plan.sp, ep=plan.ep,
                       multi_pod="pod" in mesh.mesh_dim_names,
                       kv_len_shard=plan.kv_len_shard)
    placed = shard_train_state(model, plan, mesh, state, rules=rules)
    log.info("resharded state onto mesh %s",
             dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    return placed, rules


def save_sharded(ckpt, step: int, state: dict) -> None:
    """Checkpoint a state laid out on a mesh: every rank gathers each leaf
    whole (a collective), rank 0 writes them (``CheckpointManager.save``,
    synchronously) and the others wait for it."""
    import torch.distributed as dist
    from repro_torch.sharding.place import full_tree
    full = full_tree({"params": dict(state["params"]), "opt": state["opt"],
                      "step": state["step"]})
    if dist.get_rank() == 0:
        ckpt.save(step, full)
        ckpt.wait()
    dist.barrier()


def restore_sharded(ckpt, model, plan, mesh, like: dict, rules=None):
    """(the latest checkpoint laid out on ``mesh`` by the plan's rules,
    its metadata), or (None, None) without one. Every rank reads the whole
    leaves (``like``, the state on any mesh, gives their shapes and
    types) and keeps its shards; ``rules``: the layouts' rules (default
    ``reshard_state``'s)."""
    from repro_torch.dist import rank_device
    from repro_torch.train.steps import shard_train_state
    template = {"params": dict(like["params"]), "opt": like["opt"],
                "step": like["step"]}
    full, meta = ckpt.restore_latest(template, device=rank_device())
    if full is None:
        return None, None
    if rules is None:
        return reshard_state(model, plan, mesh, full)[0], meta
    return shard_train_state(model, plan, mesh, full, rules=rules), meta
