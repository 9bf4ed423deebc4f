from .mesh import class_blocked_order, initialize_distributed, make_mesh
from .sharded import (
    ClassBlockedOLVQ1,
    dim_sharded_winner_search,
    make_ring_winner,
    ring_winner_search,
    make_dim_sharded_winner,
    make_sharded_lvq_train_step,
    make_sharded_olvq1_train_step,
    make_sharded_som_train_step,
    sharded_olvq1_step,
    sharded_som_step,
    sharded_winner_search,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "class_blocked_order",
    "sharded_som_step",
    "sharded_winner_search",
    "sharded_olvq1_step",
    "dim_sharded_winner_search",
    "make_sharded_som_train_step",
    "make_sharded_lvq_train_step",
    "make_sharded_olvq1_train_step",
    "make_dim_sharded_winner",
    "ring_winner_search",
    "make_ring_winner",
    "ClassBlockedOLVQ1",
]
