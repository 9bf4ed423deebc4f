from .dispatch import find_bmu, find_top2, som_accumulate, som_update
from .distance import chunked_topk, find_winners, sq_distances, topk_winners
from .neighborhood import grid_distance_matrix, neighborhood_weights

__all__ = [
    "sq_distances",
    "find_winners",
    "topk_winners",
    "chunked_topk",
    "find_bmu",
    "find_top2",
    "som_accumulate",
    "som_update",
    "grid_distance_matrix",
    "neighborhood_weights",
]
