from .map2partition import (
    MapToPartition, blocks_to_frame_partition, map_to_partition, th_round,
    write_partition_txt,
)
from .pipeline import StageTimes, predict_sequence
from .predict import CompPredictor
from .structural import structural_vote, structural_vote_reference

__all__ = [
    "MapToPartition", "map_to_partition", "blocks_to_frame_partition",
    "write_partition_txt", "th_round", "structural_vote",
    "structural_vote_reference", "CompPredictor", "StageTimes",
    "predict_sequence",
]
