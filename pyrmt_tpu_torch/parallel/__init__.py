"""Multi-GPU domain decomposition over ``torch.distributed`` (counterpart
of ``pyrmt_tpu.parallel``): ``make_mesh``, ``state_sharding``,
``shard_state``, ``make_sharded_step``; ``gather_state`` puts the ranks'
blocks together, ``launch.run_world`` spawns a world of ranks."""
from pyrmt_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    mesh_shape,
    gather_state,
    make_mesh,
    make_sharded_step,
    shard_state,
    state_sharding,
)
