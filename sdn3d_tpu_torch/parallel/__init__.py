"""parallel (PyTorch port of sdn3d_tpu.parallel): data parallelism over
torch.distributed, one process a card."""

from sdn3d_tpu_torch.parallel.mesh import (
    BatchDraw,
    Mesh,
    active,
    all_reduce_autograd,
    broadcast_module,
    check_world_divides,
    global_count,
    global_draw,
    global_mean,
    in_launcher,
    initialize_multihost,
    local_batch_slice,
    make_mesh,
    make_multihost_mesh,
    multihost_batch_sharding,
    rank,
    rand_rows,
    shard_batch,
    shutdown,
    sum_across_ranks,
    sum_values,
    world_size,
)
