"""Data curation (copy-paste augmentation so far)."""
