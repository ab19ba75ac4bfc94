"""Data parallelism over cards: one process a card, the gradients averaged
over the group (``mesh.py``)."""

from turtlevsr_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_mean_,
    all_reduce_sums,
    barrier,
    broadcast_params,
    check_distinct_cards,
    close_dist,
    default_group,
    init_dist,
    per_process_batch_size,
    process_is_primary,
    rank,
    shard_devices,
    world_size,
)
