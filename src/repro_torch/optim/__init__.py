from .adamw import AdamW, AdamWState, tree_leaves, tree_map
from .schedule import constant, warmup_cosine
