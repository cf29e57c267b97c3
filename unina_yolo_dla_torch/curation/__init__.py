"""Data curation: uncertainty scoring and coreset selection, difficulty
mining, SAHI auto-labeling and copy-paste augmentation."""
from .active_learning import (
    ActiveLearner,
    binary_entropy_map,
    entropy_scores,
    kcenter_greedy,
    kmeans_select,
    loc_var_scores,
)
from .auto_labeler import AutoLabeler, nms_per_class, slice_image
from .copy_paste import CopyPasteAugmentor, class_from_filename
from .mine import mine_difficulty_map

__all__ = [
    "ActiveLearner", "binary_entropy_map", "entropy_scores",
    "kcenter_greedy", "kmeans_select", "loc_var_scores",
    "AutoLabeler", "nms_per_class", "slice_image",
    "CopyPasteAugmentor", "class_from_filename",
    "mine_difficulty_map",
]
