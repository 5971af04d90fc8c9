# The kernel wrapper is ops.flash_attention.flash_attention; it is not
# re-exported here, so ``ops.flash_attention`` stays the module (its launch
# counter and plain version are patched and read through it).
from .attention import MASK_FILL, attention, dense_attention, dense_attention_bwd

__all__ = ["MASK_FILL", "attention", "dense_attention", "dense_attention_bwd"]
