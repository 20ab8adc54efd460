from .constants import TEXT_TOKEN, IGNORE_TOKEN, SPECIAL_TOKEN, PAD_TOKEN
from .schedule import compute_pruning_ratio, compute_pruning_ratio_device, CostInfeasibleError
from .patch_order import order_by_patch
from .similarity import similarity_by_patch
from .merge import descending_rank, mark_topk, apply_merge, apply_merge_weighted
from .prune import prune_keep_mask
from .compact import BUCKET, bucket_length, compaction_order, compact_tokens

__all__ = [
    "TEXT_TOKEN",
    "IGNORE_TOKEN",
    "SPECIAL_TOKEN",
    "PAD_TOKEN",
    "compute_pruning_ratio",
    "compute_pruning_ratio_device",
    "CostInfeasibleError",
    "order_by_patch",
    "similarity_by_patch",
    "descending_rank",
    "mark_topk",
    "apply_merge",
    "apply_merge_weighted",
    "prune_keep_mask",
    "BUCKET",
    "bucket_length",
    "compaction_order",
    "compact_tokens",
]
