from pylda_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    Mesh,
    all_reduce_sum,
    assert_replicas_consistent,
    host_gather,
    init_distributed,
    make_mesh,
    shutdown,
)

__all__ = [
    "COLLECTIVES",
    "Mesh",
    "all_reduce_sum",
    "assert_replicas_consistent",
    "host_gather",
    "init_distributed",
    "make_mesh",
    "shutdown",
]
