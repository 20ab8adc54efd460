"""Token-type sentinels (same values as ``framefusion_tpu.core.constants``).

``patch_type`` is an integer vector aligned with the token sequence. Image
tokens carry their spatial patch id in ``[0, patch_num)``; everything else
carries a negative sentinel. Only tokens with a non-negative patch id take
part in adjacent-frame merging.
"""

TEXT_TOKEN = -1
IGNORE_TOKEN = -2
SPECIAL_TOKEN = -9

# Fill value for padding slots introduced by bucketed compaction: padding
# never merges and never counts as a frame token.
PAD_TOKEN = -10
