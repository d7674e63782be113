"""Framework-wide constants.

Values mirror the reference VideoMAE training recipe:
ImageNet normalization (timm.data.constants, used in engine_for_pretraining.py:45-47),
canonical clip geometry 16 frames x 224^2, tubelet 2, patch 16
(modeling_finetune.py:226-248).
"""

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

# Canonical MOFO / VideoMAE clip geometry.
NUM_FRAMES = 16
IMG_SIZE = 224
PATCH_SIZE = 16
TUBELET_SIZE = 2

# Derived: 8 temporal positions x 14 x 14 spatial patches = 1568 tokens.
TEMPORAL_POSITIONS = NUM_FRAMES // TUBELET_SIZE
PATCHES_PER_SIDE = IMG_SIZE // PATCH_SIZE
PATCHES_PER_FRAME = PATCHES_PER_SIDE * PATCHES_PER_SIDE
NUM_TOKENS = TEMPORAL_POSITIONS * PATCHES_PER_FRAME

# Per-token reconstruction target size: tubelet*patch*patch*3 = 1536 values.
PIXELS_PER_TOKEN = TUBELET_SIZE * PATCH_SIZE * PATCH_SIZE * 3
